"""One dry-run step of the PyTorch port split by op: rank 0's flops by
(op, operand shapes) and collective bytes by (op, result shape), each
with the model code that called it, and the placements q, k and v reach
the flash route with (arrived, then placed).  The totals are the
report's (``python -m repro_torch.launch.dryrun``); this names their
terms.

    PYTHONPATH=src python benchmarks/torch_dryrun_by_op.py \\
        deepseek-v2-236b decode_32k [--multi-pod]

``--mesh DATAxMODEL`` traces instead one step of the cell's shape on a
fake ("data", "model") world of that size, with ``--layers``,
``--batch`` and ``--seq`` cutting the configuration and the cell
(llama4-scout's TP train step of the H100 smoke test's M7 (a)):

    PYTHONPATH=src python benchmarks/torch_dryrun_by_op.py \\
        llama4-scout-17b-a16e train_4k --mesh 2x2 --layers 1 --batch 2 \\
        --seq 2048
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import traceback
from dataclasses import replace


def _site() -> str:
    """The two innermost frames of the model code on the stack."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch/models" in f.filename]
    return " < ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.name}"
                      for f in frames[-2:][::-1])


@contextlib.contextmanager
def by_op():
    """Inside the context every ``StepCounter`` books its flops and
    collectives also into the two counters yielded, keyed by (op,
    shapes, call site)."""
    from repro_torch.launch import dryrun as D

    flops, coll = collections.Counter(), collections.Counter()
    real = D.StepCounter._count

    def count(self, func, args, kwargs, out):
        before, n = self.flops, len(self.collectives)
        real(self, func, args, kwargs, out)
        name = func._overloadpacket.__name__
        if self.flops > before:
            shapes = tuple(tuple(a.shape) for a in args
                           if hasattr(a, "shape"))
            flops[(name, shapes, _site())] += self.flops - before
        for op, b in self.collectives[n:]:
            coll[(op, tuple(getattr(out, "shape", ())), _site())] += b

    D.StepCounter._count = count
    try:
        yield flops, coll
    finally:
        D.StepCounter._count = real


@contextlib.contextmanager
def attention_placements():
    """Each call of the flash route on DTensors appends the placements
    its q, k and v arrive with and those it gives them."""
    from repro_torch.kernels.flash_attention import ops as FO

    seen, local, heads = [], FO._attention_local, FO._head_placements

    def spied_local(q, k, v, *args):
        seen.append({"arrived": [str(tuple(t.placements))
                                 for t in (q, k, v)]})
        return local(q, k, v, *args)

    def spied_heads(q, n_kv):
        qp, kvp = heads(q, n_kv)
        seen[-1]["placed"] = [str(tuple(qp)), str(tuple(kvp))]
        return qp, kvp

    FO._attention_local, FO._head_placements = spied_local, spied_heads
    try:
        yield seen
    finally:
        FO._attention_local, FO._head_placements = local, heads


def main(argv=None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell, trace_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import get_shape

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", help="DATAxMODEL: a fake world of that size")
    ap.add_argument("--layers", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    args = ap.parse_args(argv)

    with by_op() as (flops, coll), attention_placements() as seen:
        if args.mesh:
            sizes = tuple(int(n) for n in args.mesh.split("x"))
            cfg = get_config(args.arch)
            if args.layers:
                cfg = replace(cfg, n_layers=args.layers)
            cell = get_shape(args.shape)
            cell = replace(cell, global_batch=args.batch or
                           cell.global_batch, seq_len=args.seq or cell.seq_len)
            r = trace_step(cfg, cell, sizes[0] * sizes[1],
                           lambda devs: make_test_mesh(
                               sizes, ("data", "model"), devices=devs))
            print(f"flops {r['flops']:,}, collectives {r['collectives']}")
        else:
            r = run_cell(args.arch, args.shape, args.multi_pod, save=False)
            print(f"{r['status']}: flops {r.get('flops_per_device', 0):,.0f}"
                  f", collective bytes "
                  f"{r.get('collective_bytes_per_device', 0):,.0f}")
    print("flops by (op, operand shapes, call site):")
    for key, n in flops.most_common():
        print(f"  {n:,} {key}")
    print("collective bytes by (op, result shape, call site):")
    for key, n in coll.most_common():
        print(f"  {n:,} {key}")
    print("attention calls (q / k / v arrived, q / kv placed):")
    for call in seen:
        print(f"  {call}")


if __name__ == "__main__":
    main()
