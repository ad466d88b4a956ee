from .strength import strength_matrix
from .pmisr import pmisr, pmisr_existing_measure
from .ddc import ddc
from .aggregation import serial_aggregation
from .cr import cr_pass
from .device import graph_to_device, pmisr_device, pmisr_on_device
from .splitting import (cf_to_is, compute_cf_splitting,
                        compute_diag_dom_submatrix, first_pass_splitting)

__all__ = ["strength_matrix", "pmisr", "pmisr_existing_measure", "ddc",
           "serial_aggregation", "cr_pass", "compute_cf_splitting",
           "compute_diag_dom_submatrix", "first_pass_splitting", "cf_to_is",
           "graph_to_device", "pmisr_device", "pmisr_on_device"]
