"""The user's entry points (port of ``grafp_tpu.cli``): train, test_fp and
generate, each run as ``python -m grafp_tpu_torch.cli.<name>``."""
