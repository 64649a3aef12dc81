"""crushtool: compile/decompile/test crush maps (src/tools/crushtool.cc
role).

  crushtool.py -c map.txt -o map.bin         # compile text -> binary
  crushtool.py -d map.bin [-o map.txt]       # decompile binary -> text
  crushtool.py --build -o map.bin --num-osds 12 --per-host 3
  crushtool.py --test -i map.bin --rule 0 --num-rep 3 --max-x 1024 \
               [--show-utilization] [--show-bad-mappings] [--device]

ceph_tpu_torch's own copy of ``tools/crushtool.py``, run as
``python -m ceph_tpu_torch.tools.crushtool``. ``--test --device`` runs
the rule on the bulk engine (kernel K4, ``csrc/crush_rule.cu``) on the
CUDA card, and ``--device cpu`` on its plain version; without
``--device`` the host oracle runs, as in the reference. With no card,
``--device`` raises: it never drops to the CPU.
"""
from __future__ import annotations

import argparse
import signal
import sys

from ..placement import compiler, crushmap as cm
from ..placement import encoding as menc
from ..placement.tester import test_rule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", metavar="TXT", help="compile text map")
    ap.add_argument("-d", metavar="BIN", help="decompile binary map")
    ap.add_argument("-o", metavar="OUT", help="output file")
    ap.add_argument("-i", metavar="BIN", help="input binary map (--test)")
    ap.add_argument("--build", action="store_true",
                    help="build a simple host/osd hierarchy")
    ap.add_argument("--num-osds", type=int, default=12)
    ap.add_argument("--per-host", type=int, default=3)
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--max-x", type=int, default=1024)
    ap.add_argument("--device", nargs="?", const=True, default=False,
                    help="run the batched device placement engine: "
                         "on the CUDA card, or on the torch device "
                         "named (cpu: its plain version)")
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    args = ap.parse_args(argv)

    if args.c:
        m = compiler.compile(open(args.c).read())
        blob = menc.encode_crushmap(m)
        out = args.o or args.c + ".bin"
        open(out, "wb").write(blob)
        print(f"wrote {len(blob)} bytes to {out}")
        return 0
    if args.d:
        m, _ = menc.decode_crushmap(open(args.d, "rb").read())
        text = compiler.decompile(m)
        if args.o:
            open(args.o, "w").write(text)
            print(f"wrote {args.o}")
        else:
            sys.stdout.write(text)
        return 0
    if args.build:
        n_hosts = -(-args.num_osds // args.per_host)
        m = cm.build_hierarchy(args.per_host, n_hosts)
        m.add_rule(cm.replicated_rule(0, failure_domain_type=1))
        m.add_rule(cm.ec_rule(1, failure_domain_type=1))
        out = args.o or "map.bin"
        open(out, "wb").write(menc.encode_crushmap(m))
        print(f"built {n_hosts} hosts x {args.per_host} osds -> {out}")
        return 0
    if args.test:
        if not args.i:
            ap.error("--test needs -i map.bin")
        m, _ = menc.decode_crushmap(open(args.i, "rb").read())
        rep = test_rule(m, args.rule, args.num_rep,
                        n_inputs=args.max_x, device=args.device)
        print(f"rule {args.rule}, num_rep {args.num_rep}, "
              f"{args.max_x} inputs: placed {rep.placed}, "
              f"{len(rep.bad_mappings)} bad mappings, "
              f"max deviation {rep.max_deviation(m):.4f}")
        if args.show_utilization:
            exp = rep.expected_utilization(m)
            for d, u in rep.utilization().items():
                print(f"  device {d}\tactual {u:.4f}\texpected "
                      f"{exp.get(d, 0.0):.4f}")
        if args.show_bad_mappings and rep.bad_mappings:
            print(f"  bad: {rep.bad_mappings[:20]}"
                  + (" ..." if len(rep.bad_mappings) > 20 else ""))
        return 1 if rep.bad_mappings else 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    # head-friendly CLI: a closed stdout pipe is a normal exit. Set
    # only when run as a program — at import time this would strip
    # the hosting process (e.g. pytest) of CPython's SIGPIPE ignore
    # and a later write to any dead socket would kill it (exit 141).
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
