from .ba import BAProblem, BAResult, bundle_adjust, bundle_adjust_cg, local_ba
