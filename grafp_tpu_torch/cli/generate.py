"""`python -m grafp_tpu_torch.cli.generate`: the generate CLI on the card
(see generate_main.py)."""

from grafp_tpu_torch.cli.generate_main import main

if __name__ == "__main__":
    main()
