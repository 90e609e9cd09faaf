"""The paper's own experiments on the port (port of the JAX package's
``benchmarks/`` modules for Fig. 1/2/4/5/6/10/11 and rTop-k): each
module keeps the reference's ``run(smoke)`` / ``collect(smoke)`` /
``main(argv)``, shapes, steps, workers and row names, and takes
``device`` (the card unless told ``"cpu"``).  ``python -m
repro_torch.benchmarks.run [module] [--smoke] [--device cpu]`` runs
them.  No benchmark writes a file unless its ``--json`` names one."""
