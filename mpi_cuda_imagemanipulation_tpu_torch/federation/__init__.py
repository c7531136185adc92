"""Multi-pod federation, the tier above the fabric. The counterpart of
the JAX package's ``federation/``, of which the port has the pod side
so far: `control.py`, the pod-level heartbeat a fabric router pushes to
a front door (fabric/router.py `Router.federate`). The front door, its
quota leases and its durable registry (``frontdoor.py``, ``quota.py``,
``registry.py``) are still to be ported.
"""
