"""Serving helpers; so far the shape buckets and stack padding
(bucketing.py) that `batch` uses."""
