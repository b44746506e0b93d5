"""repro_torch.launch — the training launcher (``launch.train``), the
logical (data, model) mesh and its sharding rules (``launch.mesh``), and
the allocation-free dry run over every (arch x shape x mesh) cell
(``launch.dryrun``): the port of the JAX package's ``launch``."""
