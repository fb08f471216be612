"""The benchmark of the PyTorch port (`druid_tpu_torch`) on one CUDA card.

Everything is found by name: a configuration in `configs/<name>.json`
(its columns made by `gen/<generator>.py`), a traffic mix in
`mixes/<name>.json`, and each metric's reader in `metrics/<name>.py`.
`run.py` is the entry; `reference.py` is the plain PyTorch reference that
decides `correct`, and it imports nothing of the port.
"""
