"""The ``sink`` phase's ``ssh`` case as ``chip_smoke.py`` drew it in PR 25's
first try of its third chip run, rebuilt and held against the JAX package.

In that try the new kernel cases drew from the smoke's one shared generator
(before ``NEW_CASES_SEED`` gave them their own), which moved the inputs of
every later phase, and the ``ssh`` case's dsink per-block check read 1.019
of its tolerance. Two steps:

``replay PARENT OUT_DIR`` (on the card): runs PARENT's ``chip_smoke.py``
(a checkout of the commit that added ``NEW_CASES_SEED``, e.g. ``git archive
98c07c3``) with the new cases back on the shared generator, up to and
through the ``sink`` phase, leaving out the phases that draw nothing from
it (the trainer's, seeded on its own, and the split tuner's), and saves the
``ssh`` case's inputs and both dsinks (the kernel path's and the plain
path's, ``MAGI_ATTENTION_KERNEL_BACKEND=torch`` on the card) to
``OUT_DIR/ssh_case.npz``; it prints the dsink check's numbers.

``compare NPZ`` (on the CPU, needs the JAX package): dsink of the same
inputs through the JAX package's ``flash_attention_with_sink`` (jnp
backend), and through a float64 oracle; prints each dsink's errors against
the others by the smoke's three gradient checks.

    python3 tools/sink_case.py replay .scratch/parent chiprun_out/sink_case
    JAX_PLATFORMS=cpu python3 tools/sink_case.py compare chiprun_out/sink_case/ssh_case.npz
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_HOOK = '''

if __name__ == "__main__":
    import numpy as np
    import torch
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    captured = {}
    real_entry, real_check = entry_fwd_bwd, check_against_plain

    def entry(fn, q, k, v, dout, dlse, extra=()):
        res = real_entry(fn, q, k, v, dout, dlse, extra)
        if q.shape[1] == SINK_SMALL_T and extra and extra[0].dim() == 4 and "inputs" not in captured:
            bits = lambda x: x.detach().contiguous().view(torch.int16).cpu().numpy()
            captured["inputs"] = dict(q=bits(q), k=bits(k), v=bits(v), dout=bits(dout),
                                      dlse=dlse.float().cpu().numpy(),
                                      sink=extra[0].float().cpu().numpy())
        return res

    def check_plain(name, got, ref, *a, **kw):
        if name.startswith("sink_ssh"):
            errs, failed = grad_errors(got["grads"][3].reshape(1, -1, 1),
                                       ref["dsink"].reshape(1, -1, 1))
            emit({"replay": "ssh_dsink", "errs": errs, "failed": failed})
            np.savez(os.path.join(out_dir, "ssh_case.npz"), **captured["inputs"],
                     dsink_kernel=got["grads"][3].float().cpu().numpy(),
                     dsink_plain=ref["dsink"].float().cpu().numpy(),
                     lse_kernel=got["lse"].float().cpu().numpy(),
                     lse_plain=ref["lse"].float().cpu().numpy())
            try:
                return real_check(name, got, ref, *a, **kw)
            except SmokeFailure as exc:
                emit({"replay": "ssh_check_failed", "what": str(exc)})
                return errs
        return real_check(name, got, ref, *a, **kw)

    entry_fwd_bwd, check_against_plain = entry, check_plain
    sys.exit(main([]))
'''


def replay(parent: str, out_dir: str) -> int:
    """PARENT's smoke, its new cases on the shared generator, to the sink
    phase's end (see the module's note)."""
    src = open(os.path.join(parent, "chip_smoke.py")).read()
    at = src.index("def main(argv=None) -> int:")
    body = src[at:]
    edits = [
        ("    gen_new = torch.Generator(device=\"cuda\")\n"
         "    gen_new.manual_seed(args.seed + NEW_CASES_SEED)\n",
         "    gen_new = gen  # the first try: one shared generator\n"),
        ("    train = training(args.seed, grads_path)\n    emit(train)\n", ""),
        ("    tune_serving = tune_splits_serving(engine, slots)  # the tuning phase's split part\n",
         ""),
    ]
    for old, new in edits:
        if body.count(old) != 1:
            raise SystemExit(f"{parent}/chip_smoke.py is not the expected checkout: {old!r}")
        body = body.replace(old, new)
    end = body.index("    sink_line = sink_phase(gen)\n")
    body = body[:end] + "    sink_line = sink_phase(gen)\n    emit(sink_line)\n    return 0\n"
    path = os.path.join(parent, "chip_smoke_sink_replay.py")
    with open(path, "w") as f:
        f.write(src[:at] + body + _HOOK)
    return subprocess.call([sys.executable, path, os.path.abspath(out_dir)])


def compare(npz: str) -> int:
    """dsink through JAX (jnp backend) and a float64 oracle, against the
    card's two; prints one JSON object."""
    import numpy as np
    import torch

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from magiattention_tpu import env as jax_env
    from magiattention_tpu.extensions import flash_attention_with_sink

    from chip_smoke import grad_errors  # the smoke's three checks (torch only)

    z = np.load(npz)
    f32 = {n: torch.from_numpy(z[n]).view(torch.bfloat16).float().numpy()
           for n in ("q", "k", "v", "dout")}
    dlse, sink = z["dlse"], z["sink"]
    jax_env.kernel_backend = lambda: "jnp"

    def jax_dsink(dtype):
        args = [jnp.asarray(f32[n], dtype=dtype) for n in ("q", "k", "v")]
        s = jnp.asarray(sink, dtype=jnp.float32 if dtype == jnp.bfloat16 else dtype)

        def fwd(q, k, v, s):
            return flash_attention_with_sink(q, k, v, s, sink_layout="ssh", causal=True,
                                             return_lse=True)

        _, vjp = jax.vjp(fwd, *args, s)
        cot = (jnp.asarray(f32["dout"], dtype=dtype), jnp.asarray(dlse, dtype=s.dtype))
        return np.asarray(vjp(cot)[3], dtype=np.float64)

    def oracle():
        """Causal attention with the ssh sink in float64 from the same
        values: dsink = softmax over the row's sinks x (dlse' - dout . out')
        at the corrected (out', lse'), by hand."""
        q, k, v, do = (torch.from_numpy(f32[n]).double() for n in ("q", "k", "v", "dout"))
        b, t, hq, d = q.shape
        g = hq // k.shape[2]
        kk, vv = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / d ** 0.5
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
        lse = torch.logsumexp(s, -1)  # [b, h, q]
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
        sk = torch.from_numpy(sink).double()  # [b, t, S, hq]
        lse_s = torch.logsumexp(sk, 2)  # [b, t, hq]
        lse_tot = torch.logaddexp(lse.transpose(1, 2), lse_s)
        out_tot = out * torch.exp(lse.transpose(1, 2) - lse_tot)[..., None]
        grad_lse_tot = torch.from_numpy(dlse).double() - (do * out_tot).sum(-1)
        share = torch.softmax(sk, 2) * torch.exp(lse_s - lse_tot)[:, :, None]
        return (share * grad_lse_tot[:, :, None]).numpy()

    got = {"kernel": z["dsink_kernel"].astype(np.float64),
           "plain": z["dsink_plain"].astype(np.float64),
           "jax_bf16": jax_dsink(jnp.bfloat16), "jax_f32": jax_dsink(jnp.float32),
           "oracle_f64": oracle()}

    def held(a, ref):
        errs, failed = grad_errors(torch.from_numpy(got[a]).reshape(1, -1, 1).float(),
                                   torch.from_numpy(got[ref]).reshape(1, -1, 1).float())
        return {**errs, "failed": failed}

    pairs = [("kernel", "plain"), ("plain", "jax_bf16"), ("kernel", "jax_bf16"),
             ("jax_bf16", "oracle_f64"), ("plain", "oracle_f64"), ("kernel", "oracle_f64"),
             ("jax_f32", "oracle_f64")]
    print(json.dumps({f"{a}_vs_{b}": held(a, b) for a, b in pairs}, indent=1))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "replay":
        sys.exit(replay(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
