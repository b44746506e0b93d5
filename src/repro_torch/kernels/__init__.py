"""Hand-written Hopper kernels of the Indirect Access unit.

  gather/       row-table gather       (csrc/row_table_gather.cu)
  scatter_rmw/  row-table scatter-RMW  (csrc/row_table_rmw.cu)

Each package has the kernel's wrapper (``gather.py`` / ``scatter_rmw.py``,
with a ``launches`` counter), its plain PyTorch version (``ref.py``) and the
plan-level wrapper (``ops.py``). ``build`` compiles the CUDA sources at
first use; nothing here imports ``ctypes`` or touches CUDA at import time.
"""
