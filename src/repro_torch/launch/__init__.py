"""Launchers of the port: the serving and training CLIs (``serve``,
``train``), the production meshes (``mesh``) and the multi-pod dry-run
(``dryrun``)."""
