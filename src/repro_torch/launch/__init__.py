# dryrun starts a process-wide fake process group: run it as the entry
# module of a process of its own (python -m repro_torch.launch.dryrun)
from .mesh import data_axes, make_production_mesh, make_test_mesh
