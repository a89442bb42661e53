"""Where does batched search time go at read-mapping shapes?

Times, on the real chip at the nanopore shape (Q patterns x one long
text): the bare scan kernel, the full fused dispatch (scan + selection),
and the end-to-end engine call (incl. fetch + decode + retries). The
differences attribute time to selection vs host-side work.
python scripts/profile_batch.py [Q] [MB]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    from sassy_tpu.ops import batch as B
    from sassy_tpu.ops.myers_xla import _kernels, pattern_inputs_np
    from sassy_tpu.profiles import Iupac

    Q = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    MB = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    k = 3
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=MB << 20)
    pats = [rng.choice(bases, size=24) for _ in range(Q)]
    prof = Iupac()
    eng = B.BatchEngine()
    codes = [prof.encode(p) for p in pats]

    # engine end-to-end (rep 2+ = caps warmed)
    def full():
        return eng.candidates_many(prof, codes, [text], k)

    full()
    t0 = time.perf_counter()
    out = full()
    t_full = time.perf_counter() - t0
    nm = sum(len(out[q][0]) for q in range(Q))
    print(f"end-to-end candidates_many: {t_full*1e3:7.1f} ms  ({nm} matches)")

    # reproduce the engine's planning for direct dispatch timing
    per = [pattern_inputs_np(prof, c, None, None) for c in codes]
    M = per[0][0].shape[0]
    halo = M + k
    ts = B.TextSet([text])
    w_chars, pad_mult, t_chunk, _ = eng.plan(ts, prof, M, 0, halo, Q)
    pieces, planes_all, tv_all = ts.packed(prof, 0, halo, w_chars, pad_mult)
    nchunks = -(-len(pieces) // t_chunk)
    print(f"Q={Q} text={MB}MB w_chars={w_chars} pieces={len(pieces)} "
          f"t_chunk={t_chunk} chunks={nchunks}")

    blob = np.concatenate(
        [
            np.stack([p[0] for p in per]).reshape(Q, -1),
            np.stack([p[1] for p in per]),
            np.stack([p[2] for p in per]),
            np.array([[24]] * Q, np.uint32),
            np.array([[p[3]] for p in per], np.uint32),
        ],
        axis=1,
    ).astype(np.uint32)
    patblob = jnp.asarray(blob)

    scan_win_q = _kernels()["scan_win_q"]
    p_pat = 4

    @jax.jit
    def scan_only(planes_all, tv_all, t0c, patblob):
        planes_tw = jax.lax.dynamic_slice(
            planes_all, (0, t0c, 0),
            (planes_all.shape[0], t_chunk, planes_all.shape[2]),
        )
        tilevec = jax.lax.dynamic_slice(tv_all, (0, t0c), (5, t_chunk))
        Qb, cols = patblob.shape
        Mn = (cols - 2) // (p_pat + 2)
        pm = patblob[:, : Mn * p_pat].reshape(Qb, Mn, p_pat)
        ip = patblob[:, Mn * p_pat : Mn * p_pat + Mn]
        hi = patblob[:, Mn * p_pat + Mn : Mn * p_pat + 2 * Mn]
        mv = patblob[:, -2].astype(jnp.int32)
        bv = patblob[:, -1].astype(jnp.int32)
        vp, vm, cw = scan_win_q(
            planes_tw.transpose(2, 0, 1), tilevec[0] != 0, pm, ip, hi,
            mv, bv, "iupac", eng.backend, eng.interpret,
        )
        return jnp.sum(cw[:, -1, :])  # tiny result, no big fetch

    def sync_scan():
        outs = [scan_only(planes_all, tv_all, np.int32(c * t_chunk), patblob)
                for c in range(nchunks)]
        return np.asarray(jnp.stack(outs).ravel()[:1])

    sync_scan()
    t0 = time.perf_counter()
    sync_scan()
    t_scan = time.perf_counter() - t0
    print(f"scan-only ({nchunks} chunks):  {t_scan*1e3:7.1f} ms")

    fn = B._batch_fn("iupac", False, 1 << 12, 1 << 10, True, 0,
                     eng.backend, eng.interpret, t_chunk)

    def sync_dispatch():
        outs = [fn(planes_all, tv_all, np.int32(c * t_chunk), patblob,
                   np.int32(k), np.float32(0.0)) for c in range(nchunks)]
        return np.asarray(jnp.stack(outs))  # the real fetch

    sync_dispatch()
    t0 = time.perf_counter()
    got = sync_dispatch()
    t_disp = time.perf_counter() - t0
    print(f"scan+select+fetch:        {t_disp*1e3:7.1f} ms")
    print(f"  -> selection+fetch adds {max(0., t_disp-t_scan)*1e3:7.1f} ms")
    print(f"  -> host decode etc adds {max(0., t_full-t_disp)*1e3:7.1f} ms")


if __name__ == "__main__":
    main()
