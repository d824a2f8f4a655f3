"""``python -m instarevive_tpu_torch.train``: the training launcher
(``train/launcher.py``)."""

from instarevive_tpu_torch.train.launcher import main

if __name__ == "__main__":
    main()
