"""The benchmark's plain reference: plain PyTorch that imports nothing of
the program (frozen copies of the port's plain arithmetic, brute-force
traces, its own scene parsing and bake)."""
