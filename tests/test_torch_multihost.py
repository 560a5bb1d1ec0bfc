"""``initialize_multihost`` over TCP: two OS processes join one gloo world,
as tests/test_multihost.py does for ``jax.distributed``; once with explicit
arguments, once from torchrun's environment variables.  Across the process
boundary the chain-sharded keyed product must equal the unsharded keyed
call bitwise, and the kernel-sharded replay product (whose CDF collectives
cross it) the serial oracle.

Worker mode: ``python tests/test_torch_multihost.py --worker <rank> <world>
<url> <out> <args|env> <port>`` (torch only)."""
import os
import socket
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import gibbs_streams  # noqa: E402
from torch_world import ROOT, assert_replicated, run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data():
    rng = np.random.default_rng(7)
    dens = [(rng.normal(size=(2, 8)), [0.3]),
            (rng.normal(size=(2, 8)) + 0.5, [0.4])]
    ru, rn, _ = gibbs_streams(np.random.default_rng(11), 2, 2, 8, 1, 8)
    return dens, ru, rn


def _worker(argv):
    rank, world, out, (form, port) = (int(argv[2]), int(argv[3]), argv[5],
                                      argv[6:8])
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    from kde_tpu_torch.parallel import (
        KERNELS, initialize_multihost, make_mesh,
        prod_appx_ms_gibbs_kernel_sharded, prod_appx_ms_gibbs_sharded)
    from torch_world import PG_TIMEOUT, worker_finish
    if form == "args":
        initialize_multihost(f"127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout=PG_TIMEOUT)
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          RANK=str(rank), WORLD_SIZE=str(world))
        initialize_multihost(backend="gloo", timeout=PG_TIMEOUT)
    dens, ru, rn = _data()
    dens = [kt.kde(p, bw, dtype=torch.float64) for p, bw in dens]
    res = {}
    pts, idx = prod_appx_ms_gibbs_sharded(make_mesh(), 8, dens, n_iter=1,
                                          key=0)
    res["chain/pts"], res["chain/idx"] = pts.numpy(), idx.numpy()
    pts, idx = kt.prod_appx_ms_gibbs(8, dens, n_iter=1, key=0, select="cdf")
    res["chain/want_pts"], res["chain/want_idx"] = pts.numpy(), idx.numpy()
    pts, idx = prod_appx_ms_gibbs_kernel_sharded(
        make_mesh(axis_name=KERNELS), 8, dens, n_iter=1, rand_u=ru,
        rand_n=rn)
    res["kernel/pts"], res["kernel/idx"] = pts.numpy(), idx.numpy()
    worker_finish(rank, out, res)


@pytest.mark.skipif(sys.platform != "linux", reason="gloo transport")
@pytest.mark.parametrize("form", ["args", "env"])
def test_two_process_tcp_world(tmp_path, form):
    from kde_tpu import kde
    from kde_tpu.reference_impl import serial_gibbs_product
    world = run_world(os.path.abspath(__file__), tmp_path, world=2,
                      timeout=180, args=(form, str(_free_port())))
    assert_replicated(world)
    res = world[0]
    np.testing.assert_array_equal(res["chain/idx"], res["chain/want_idx"])
    np.testing.assert_array_equal(res["chain/pts"], res["chain/want_pts"])
    dens, ru, rn = _data()
    pts_s, idx_s, _ = serial_gibbs_product(
        [kde(p, bw).tree for p, bw in dens], 8, 1, ru, rn)
    np.testing.assert_array_equal(res["kernel/idx"], idx_s)
    np.testing.assert_allclose(res["kernel/pts"], pts_s, rtol=1e-9,
                               atol=1e-12)


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
