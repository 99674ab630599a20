"""The user's entry points (port of ``grafp_tpu.cli``): train, test_fp and
generate, and the baseline encoders' drivers baseline_train and
baseline_test_fp (the JAX package's ``baselines/``), each run as
``python -m grafp_tpu_torch.cli.<name>``."""
