"""Starting the worker processes of ``Engine(backend="dist")``
(``repro_torch.launch.workers``) and the jobs they run
(``repro_torch.launch.jobs``)."""
