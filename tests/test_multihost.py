"""Multi-process (jax.distributed) sharded search on CPU.

Launches real N-process jax.distributed jobs (subprocesses on localhost)
where each process holds a slice of virtual CPU devices, runs
``multihost.global_search`` over the global 8-device mesh, and checks the
gathered candidates against the NumPy oracle — the host-level (DCN) analog
of the 8-device single-process dryrun. Covers N=2 (4 devices each) and
N=4 (2 devices each; more DCN edges, smaller per-host shard).
"""

import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys, json
    import numpy as np

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count={devs_per_proc}"
    )
    import jax
    jax.config.update("jax_platforms", "cpu")

    coord, pid = sys.argv[1], int(sys.argv[2])
    sys.path.insert(0, {repo!r})
    from sassy_tpu.parallel import multihost
    multihost.initialize(coordinator_address=coord,
                         num_processes={num_procs}, process_id=pid)
    assert jax.process_count() == {num_procs}, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    from sassy_tpu.profiles import Iupac
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=5000)
    pats = [rng.choice(bases, size=9) for _ in range(2)]
    text[100:109] = pats[0]
    got = multihost.global_search(Iupac(), pats, text, 2)
    if pid == 0:
        print("RESULT " + json.dumps([[list(c) for c in row] for row in got]))
    """
)


def _run_global_search(tmp_path, num_procs: int):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(
        repo="/root/repo", num_procs=num_procs,
        devs_per_proc=8 // num_procs,
    ))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), addr, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(num_procs)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost workers timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)

    import json

    line = next(
        ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")
    )
    return json.loads(line[len("RESULT "):])


def _check_against_oracle(got):
    import numpy as np

    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import NumpyEngine

    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=5000)
    pats = [rng.choice(bases, size=9) for _ in range(2)]
    text[100:109] = pats[0]
    prof = Iupac()
    oracle = NumpyEngine()
    for q, pat in enumerate(pats):
        want = oracle.candidates(
            prof, prof.encode(pat), text, 2, None, None, False
        )
        assert sorted(map(tuple, got[q])) == sorted(map(tuple, want))


@pytest.mark.slow
def test_two_process_global_search(tmp_path):
    _check_against_oracle(_run_global_search(tmp_path, 2))


@pytest.mark.slow
def test_four_process_global_search(tmp_path):
    _check_against_oracle(_run_global_search(tmp_path, 4))
