"""The experiment CLIs of the port: ``python -m
njode_tpu_torch.experiments.experiment_{black_scholes,ou,heston,hybrid}``
and ``python -m njode_tpu_torch.experiments.compare_experiments``, with the
JAX package's flags.  Each module's ``main(argv=None)`` can also be called
in process; nothing is parsed at import."""
