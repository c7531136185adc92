"""Online autotuning, the counterpart of the JAX package's ``tune/``.

  * `store`   - online observations under the autotune keys (device kind,
                pipeline fingerprint, width window), with staleness decay
                and a rate-limited merge into the calibration file, and
                `effective_plan_choice`, the newest-wins rule between an
                offline ``plan_choice`` record and an online promotion
                that ``plan='auto'`` follows;
  * `metrics` - the `mcim_tune_*` metric family.

The JAX package's ``controller`` (the explore/exploit engine that deploys
winners through the canary gate) imports its fabric layer and comes with
the port's.
"""
