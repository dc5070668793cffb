"""The port's twins of ``examples/``: how a user first meets the system,
on one NVIDIA H100 unless given ``--device cpu``.

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.serve_batch [--device cpu] ...
    python -m repro_torch.examples.train_100m [--device cpu] ...
    python -m repro_torch.examples.lulesh_easey [--device cpu]
"""
