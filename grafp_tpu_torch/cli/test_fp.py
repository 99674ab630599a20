"""`python -m grafp_tpu_torch.cli.test_fp`: the test_fp CLI on the card
(see test_fp_main.py)."""

from grafp_tpu_torch.cli.test_fp_main import main

if __name__ == "__main__":
    main()
