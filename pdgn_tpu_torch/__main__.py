"""``python -m pdgn_tpu_torch``: the port's entry point, ``main.py``'s
counterpart (the flags of ``pdgn_tpu_torch.cli``)."""

from pdgn_tpu_torch.cli import main

if __name__ == "__main__":
    main()
