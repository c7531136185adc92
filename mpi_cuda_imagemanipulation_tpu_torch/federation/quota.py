"""Cross-pod quota leases — one global fixed-window budget, many pods.

The counterpart of the JAX package's ``federation/quota.py``: the same
ledger, the same grants for the same sequence of calls.

The tenant quotas are enforced replica-side inside one pod, with
the router relaying a quota shed as FINAL so retries cannot multiply
the budget by replica count. Federation reopens the hole one level up:
if every pod pushes the tenant's FULL budget to its replicas, a tenant
driving P pods gets P x budget per window. The fix is the same shape as
the shed-is-final rule — make the budget a resource the upper tier
OWNS and the lower tier borrows:

    lease   an integral share of one tenant's per-window budget granted
            to one pod for the CURRENT fixed window. The pod overwrites
            the quota fields of its stored tenant config with the share
            and re-pushes to its replicas, which enforce it exactly as
            before (no replica-side changes at all).

Grant discipline (the invariant the tests pin):

  * shares are granted out of the window's REMAINING budget — the sum
    of granted shares can never exceed the budget, across any sequence
    of membership changes within a window;
  * a pod that already holds a lease for the current window gets THE
    SAME lease back (reconnect/heartbeat repeat is idempotent — an
    unexpired lease is honored, never re-split, because its tokens may
    already be spent);
  * a pod joining mid-window splits only what is still ungranted, in
    equal integral shares over the live pods that hold no lease yet;
  * a pod that dies mid-window keeps its grant on the books until the
    window rolls — conservative by construction (its unspent tokens are
    unavailable, never double-granted);
  * a new window forgets everything and re-splits over the pods live at
    grant time.

Windows are keyed by `int(now / window_s)` on the front door's clock.
Replica windows start at each tenant's first request, so the two tiers'
windows are not phase-aligned — the guarantee is "never more than one
global budget per FRONT-DOOR window", the same fixed-window semantics a
single pod already gives (graph/tenancy.py).
"""

from __future__ import annotations

import threading


class LeaseLedger:
    """Per-tenant, per-window grant book. Pure arithmetic over an
    injected clock — unit-testable with no pods anywhere."""

    def __init__(self, *, clock):
        self._clock = clock
        self._lock = threading.Lock()
        # (tenant, window_id) -> {pod_id: {"quota_requests": int|None,
        #                                  "quota_bytes": int|None}}
        self._grants: dict[tuple[str, int], dict[str, dict]] = {}
        self.grants_issued = 0

    @staticmethod
    def _split(remaining: int | None, ways: int) -> int | None:
        """One new pod's integral share of the ungranted remainder.
        Floor division is the conservative rounding: P pods can under-
        use up to P-1 tokens per window, never overrun."""
        if remaining is None:
            return None  # unlimited budget: leases are unlimited too
        return max(0, remaining) // max(1, ways)

    def lease(
        self,
        tenant: str,
        config: dict,
        pod_id: str,
        live_pods: list[str],
        now: float,
    ) -> dict:
        """The lease `pod_id` holds for tenant `tenant` in the current
        window. `config` is the tenant's registered payload (its
        quota_requests / quota_bytes / window_s fields are read here);
        `live_pods` is the current fresh-pod set (pod_id included)."""
        window_s = float(config.get("window_s") or 1.0)
        window_id = int(now / window_s)
        key = (tenant, window_id)
        with self._lock:
            # drop stale windows so the book stays bounded
            for k in [k for k in self._grants if k[0] == tenant and k[1] != window_id]:
                del self._grants[k]
            grants = self._grants.setdefault(key, {})
            held = grants.get(pod_id)
            if held is not None:
                return {**held, "window_id": window_id}
            budget_r = config.get("quota_requests")
            budget_b = config.get("quota_bytes")
            granted_r = sum(
                g["quota_requests"] or 0 for g in grants.values()
            )
            granted_b = sum(
                g["quota_bytes"] or 0 for g in grants.values()
            )
            ungranted = [
                p for p in set(live_pods) | {pod_id} if p not in grants
            ]
            share = {
                "quota_requests": self._split(
                    None if budget_r is None else int(budget_r) - granted_r,
                    len(ungranted),
                ),
                "quota_bytes": self._split(
                    None if budget_b is None else int(budget_b) - granted_b,
                    len(ungranted),
                ),
            }
            grants[pod_id] = share
            self.grants_issued += 1
            return {**share, "window_id": window_id}

    def leases_for_pod(
        self,
        pod_id: str,
        tenants: dict[str, dict],
        live_pods: list[str],
    ) -> dict[str, dict]:
        """Every quota-bearing tenant's current lease for one pod — the
        heartbeat-ack payload. Tenants with no quota at all are skipped
        (nothing to enforce, nothing to push)."""
        now = self._clock()
        out: dict[str, dict] = {}
        for tenant, config in tenants.items():
            if (
                config.get("quota_requests") is None
                and config.get("quota_bytes") is None
            ):
                continue
            out[tenant] = self.lease(
                tenant, config, pod_id, live_pods, now
            )
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "grants_issued": self.grants_issued,
                "windows": [
                    {
                        "tenant": t,
                        "window_id": w,
                        "pods": {
                            p: dict(g) for p, g in grants.items()
                        },
                    }
                    for (t, w), grants in self._grants.items()
                ],
            }
