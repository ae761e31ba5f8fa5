"""The benchmark of the PyTorch and CUDA port (facerecon_tpu_torch).

One run measures one cell of BENCHMARK.json on one H100:

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Whatever belongs to one configuration, traffic mix, entry point or
per-layer metric sits in a file of its own (configs/<config>.json,
traffic/<cell>.json, kinds/<kind>.py named by the traffic file,
metrics/<metric>.py), found by name; the run loop, the trace reader,
the work counts, the plain reference (reference/) and the comparison
are shared code.

Tests: python3 -m pytest perfbench/tests -q (on the CPU; -m cuda runs
the card's on a machine with one).
"""
