"""The port's user-facing example entry points (the counterparts of the
JAX repo's ``examples/``): the production-scale accuracy harness
(``accuracy_bench``), the synthetic smoke run (``run_synthetic``), the
results viewer (``visualize_results``) and the timing tools
(``profile_stages``, ``profile_ablate``, ``profile_ba``,
``profile_engine``). Each runs on the CUDA card unless it is given
``--cpu`` (or ``device="cpu"``), and raises without a card otherwise."""
