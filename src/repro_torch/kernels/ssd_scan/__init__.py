from .ops import SSDScan, ssd_scan, ssd_scan_backward, ssd_scan_bwd
from .ref import from_pallas_layout, ssd_ref, to_pallas_layout
