"""Input parsers (numpy only)."""

from .scan_csv import parse_lidar_scan_array

__all__ = ["parse_lidar_scan_array"]
