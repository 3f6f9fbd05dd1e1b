"""``python -m spherehand_torch``: the training and eval CLI.

Counterpart of ``python -m spherehand_tpu`` (reference ``python
network/run_engine.py``); all flags in :mod:`spherehand_torch.train.cli`.
"""
from spherehand_torch.train.cli import main

main()
