"""Multi-pod federation, the tier above the fabric. The counterpart of
the JAX package's ``federation/``.

One fabric pod is a router over N replica processes (fabric/). The
federation tier is the same design one level up: a front door
(federation/frontdoor.py) routes `/v1/*` across registered PODS, each
pod's router pushing pod-level aggregate heartbeats
(federation/control.py) the way replicas push replica heartbeats to it.
Tenant configs and pipeline specs survive a full-pod (or front-door)
restart in a durable fsync'd JSONL registry (federation/registry.py),
and a tenant's fixed-window quota holds GLOBALLY because the front door
leases per-pod token shares (federation/quota.py) instead of letting
every pod enforce the full budget.
"""
