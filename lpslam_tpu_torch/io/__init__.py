from .synthetic import make_texture, warp_homography, SyntheticSequence
from .benchmark import SyntheticBenchmark, BENCH_CAM
