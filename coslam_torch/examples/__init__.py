"""The port's user-facing example entry points (the counterparts of the
JAX repo's ``examples/``): the production-scale accuracy harness
(``accuracy_bench``), the synthetic smoke run (``run_synthetic``) and the
results viewer (``visualize_results``). Each runs on the CUDA card unless
it is given ``--cpu`` (or ``device="cpu"``), and raises without a card
otherwise."""
