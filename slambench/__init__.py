"""The benchmark of coslam_torch (the PyTorch and CUDA port of CoSLAM).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m slambench.run --workload rig3_vga.live --seed 7 \\
        --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel count is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``roofline/<kernel>.py``. The reference that
decides ``correct`` is ``reference/`` (plain PyTorch, no coslam_torch).
"""
