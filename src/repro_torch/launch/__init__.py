"""Meshes, the cell shapes, and the dry run of every arch x shape x mesh
cell over a fake process group (:mod:`.dryrun`, :mod:`.perf_iter`).

Nothing here sets up a process group at import; the dry run's fake group
is made by its command line (or by :func:`.dryrun.fake_world`)."""
