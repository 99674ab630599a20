"""Driver helpers (port of ``grafp_tpu.utils.helpers``)."""
