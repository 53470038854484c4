"""Launchers: the shard engine's graph dry-run on the ``meta`` device
(``python -m repro_torch.launch.dryrun --graph``)."""
