"""Launch tooling of the port: step functions, batching, the serve and
train CLIs, the production meshes (``mesh``) and the dry run
(``dryrun``)."""
