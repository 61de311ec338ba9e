"""Entry points of the port (``python -m repro_torch.launch.train``,
``serve``, ``dryrun``), its abstract meshes and the table of kernel
regions."""
