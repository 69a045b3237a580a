"""Storage-ecosystem shims (HDF5, zarr) around the core codec.

Counterpart of ``ebcc_tpu.wrappers``: the reference's L3/L4 integration
surface (HDF5 filters 308/310, ``EBCC_Filter``, ``EBCCZarrFilter``).
"""

from .hdf5 import (EBCCFilterParams, is_ebcc_dataset, read_dataset,
                   write_dataset)

__all__ = ["EBCCFilterParams", "write_dataset", "read_dataset",
           "is_ebcc_dataset"]
