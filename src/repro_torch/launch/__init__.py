"""Entry points of the port: the serving launcher (``serve``), the
training launcher (``train``), the production-shape dry-run (``dryrun``)
and multi-process bring-up (``multihost``), with the meshes (``mesh``)
and the analytic roofline (``roofline``) they use."""
