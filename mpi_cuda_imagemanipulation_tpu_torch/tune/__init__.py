"""Online autotuning, the counterpart of the JAX package's ``tune/``.

  * `store`   - online observations under the autotune keys (device kind,
                pipeline fingerprint, width window), with staleness decay
                and a rate-limited merge into the calibration file, and
                `effective_plan_choice`, the newest-wins rule between an
                offline ``plan_choice`` record and an online promotion
                that ``plan='auto'`` follows;
  * `controller` - a UCB-style explore/exploit engine on the fabric
                router's tick that ranks candidate config flips from those
                observations and deploys winners through the canary gate
                (fabric/canary.py), promoting them pod-wide or rolling
                them back; one digest mismatch quarantines the candidate;
  * `metrics` - the `mcim_tune_*` metric family.
"""
