"""Several processes, one a device: the process layout and its collectives
(mesh.py), the launcher (launch.py) and a dry run (dryrun.py)."""
