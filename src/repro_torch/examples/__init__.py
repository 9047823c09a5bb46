"""The reference's examples as modules of the port: ``quickstart``,
``serve_multi_agent`` and ``cross_cluster_sim`` (``train_lm`` is
:mod:`repro_torch.training.train_lm`). Run each with ``python -m
repro_torch.examples.<name>``."""
