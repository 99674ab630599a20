"""The user's entry points (port of ``grafp_tpu.cli``): train, test_fp and
generate, the baseline encoders' drivers baseline_train and
baseline_test_fp (the JAX package's ``baselines/``), and the reproduction
set-up setup_config and setup_icassp (the root scripts), each run as
``python -m grafp_tpu_torch.cli.<name>``; train also under ``torchrun``."""
