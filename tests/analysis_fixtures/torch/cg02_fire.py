"""CG02 fire: host randomness and a clock read in code captured into a
CUDA graph: every replay repeats the capture's draw and time."""
import time

import numpy as np
import torch


class Step:
    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.elapsed = 0.0

    def _noise(self, x):
        return x + float(np.random.rand())

    def record(self, x, out):
        with torch.cuda.graph(self.graph):
            t0 = time.perf_counter()
            out.copy_(self._noise(x))
            self.elapsed = t0
