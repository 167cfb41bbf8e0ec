from .synthetic import make_texture
from .benchmark import SyntheticBenchmark, BENCH_CAM
