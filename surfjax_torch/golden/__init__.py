"""The golden oracles: the NumPy renderer (`renderer`) and the strict-FP
C++ renderer behind a ctypes bridge (`cpp_bridge`). Both run on the host."""
