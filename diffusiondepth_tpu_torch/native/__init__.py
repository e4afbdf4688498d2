"""Native (C++) data-pipeline ops, bound with ctypes: the scanline depth
completion and the PNG scanline unfilter (``depthops.cpp``, built at first
use), the PNG reader and writer built on them (``png.py``), and the HDF5
reader and writer of the NYU files (``hdf5.py``, numpy and ``struct``)."""
