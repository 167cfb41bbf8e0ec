from .mesh import make_mesh, default_mesh
from .sharded_ba import distributed_bundle_adjust
from .sharded_map import sharded_global_ba, sharded_global_ba_problem, sharded_bow_scores
from .resident import ResidentMap, map_shardings
