"""Input parsers, trajectory and g2o pose-graph files (numpy, then tensors on the card unless
``device="cpu"``)."""

from .g2o import read_g2o, write_g2o
from .ply import read_ply, write_ply
from .scan_conf import parse_sweep, parse_sweep_conf, sweep_to_points
from .scan_csv import parse_lidar_scan, parse_lidar_scan_array, parse_lidar_scan_batch
from .trajectory import read_tum, write_tum

__all__ = [
    "parse_lidar_scan",
    "parse_lidar_scan_array",
    "parse_lidar_scan_batch",
    "parse_sweep",
    "parse_sweep_conf",
    "read_g2o",
    "read_ply",
    "read_tum",
    "sweep_to_points",
    "write_g2o",
    "write_ply",
    "write_tum",
]
