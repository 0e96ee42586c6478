"""The operation counts reproduce the port's kernel table at the V2 10 s
clip (861 frames; K5's bytes at its bucket of 1024 frames, as the table
counts them)."""

import pytest

from ovbench import flops
from ovbench.reference.model import Config


def test_kernel_table_counts():
    c = Config()
    assert flops.k1(c, 861)[0] / 1e9 == pytest.approx(12.12, abs=0.005)
    assert 2 * flops.k2(c, 861)[0] / 1e9 == pytest.approx(24.38, abs=0.005)   # both directions
    assert flops.k3(c, 861)[0] / 1e9 == pytest.approx(341.27, abs=0.005)
    assert flops.k4(c, 861)[0] / 1e9 == pytest.approx(176.15, abs=0.005)
    assert flops.k5(c, 1024)[1] / 1e6 == pytest.approx(3.16, abs=0.005)


def test_request_counts_add_up():
    c = Config()
    work = {"convert": [861, 100]}
    k = flops.request_kernels({"convert": c}, work)
    assert k["mrf_cuda"][0] == pytest.approx(flops.k3(c, 861)[0] + flops.k3(c, 100)[0])
    assert k["coupling_cuda"][0] == pytest.approx(2 * (flops.k2(c, 861)[0] + flops.k2(c, 100)[0]))
    total = flops.request_flops({"convert": c}, work)
    assert total > sum(v[0] for v in k.values())   # the stock layers outside the kernels add work
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert flops.peaks("NVIDIA H100 PCIe") is None
