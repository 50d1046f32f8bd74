from .ops import ssd_scan
from .ref import from_pallas_layout, ssd_ref, to_pallas_layout
