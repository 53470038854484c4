"""Launchers: the shard engine's graph dry-run on the ``meta`` device
(``python -m repro_torch.launch.dryrun --graph``) and the training CLI
(``python -m repro_torch.launch.train``)."""
