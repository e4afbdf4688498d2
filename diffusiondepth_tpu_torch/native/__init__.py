"""Native (C++) data-pipeline ops, bound with ctypes: the scanline depth
completion and the PNG scanline unfilter (``depthops.cpp``, built at first
use), and the PNG reader and writer built on them (``png.py``)."""
