"""The pipeline service's pieces, so far the QoS admission ladder
(tenancy.py) that the serving scheduler shares with it."""
