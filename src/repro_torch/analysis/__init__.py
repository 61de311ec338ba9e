"""The port's block-space checker (port of ``repro/analysis``).

Five passes, each a list of ``contracts.CheckResult``:

  envelope    derive the int32 envelopes of the tensor and device maps
              from the port's own float32 arithmetic and certify them at
              every floor seam (``envelope.py``);
  contracts   prove every registered schedule kind's declared contract:
              counting, partition, boundary probes, inverse round-trips,
              the tensor maps on the device, at n up to 10^4
              (``contracts.py`` + ``verifier.py``);
  launch      call every public kernel op once and hold its launches to
              declared literals, the member-table ABI, capacities, dtypes
              and schedule step counts (``launch_lint.py``);
  obs         no kernel launch outside obs.launch, counters against the
              profiler on the card, the schema self-check (``obs_lint.py``);
  resilience  ladder and counter vocabulary, event emission gates, faulted
              runs token-identical (``resilience_lint.py``).

Run with ``python -m repro_torch.analysis.lint [--device cuda|cpu]``.
"""
