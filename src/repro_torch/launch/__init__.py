"""repro_torch.launch — the training launcher (``launch.train``), the
(data, model) meshes, logical over one device or one rank per process
(``make_process_mesh``), and their sharding rules (``launch.mesh``), and
the allocation-free dry run over every (arch x shape x mesh) cell
(``launch.dryrun``): the port of the JAX package's ``launch``."""
