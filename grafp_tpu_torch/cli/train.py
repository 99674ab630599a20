"""`python -m grafp_tpu_torch.cli.train`: the train CLI on the card
(see train_main.py)."""

from grafp_tpu_torch.cli.train_main import main

if __name__ == "__main__":
    main()
