"""The benchmark's yardstick: plain PyTorch and NumPy that import nothing
of the program under test (the traffic's renderer and trajectory, the
reference computations that decide ``correct``, the device-trace reader
and the byte counts of the rooflines)."""
