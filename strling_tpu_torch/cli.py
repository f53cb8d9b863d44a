"""strling_tpu_torch command-line interface.

The same subcommands, flags and output files as `strling_tpu.cli` (the
reference dispatcher, src/strling.nim:12-44). `extract` and `index` run the
port, on the device given by `--device` (`cuda`, the default, needs a card;
`cpu` runs the plain PyTorch scan). The other subcommands are host code: the
port's copies of the reference's implementations. `extract`, `merge` and
`call` take `--distributed` (one torch.distributed rank a device; launch with
`torchrun --nproc-per-node N -m strling_tpu_torch.cli ...`), `extract` and
`call` take `--profile DIR` (a torch.profiler trace). The JAX package's
`--platform` and its compile cache are JAX's own and have no counterpart.

  extract      extract informative STR reads from a BAM. Required first step.
  merge        merge putative STR loci from multiple samples (joint calling).
  call         call STRs.
  index        identify large STRs in the reference genome -> <fasta>.str
  pull_region  debugging; pull all reads (and mates) for a region.
  outliers     cohort-level outlier statistics.
  simulate     simulate reads with STR expansions.
"""

from __future__ import annotations

import argparse
import os
import sys

from strling_tpu_torch import __version__

def _add_device(p):
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the repeat-unit scan runs: cuda (default; needs a"
                        " GPU) or cpu (the plain PyTorch form)")


def _extract(argv):
    p = argparse.ArgumentParser("strling extract")
    p.add_argument("-f", "--fasta", default="", help="path to fasta file (required for CRAM)")
    p.add_argument("-g", "--genome-repeats", default="", help="optional path to genome repeats file. if it does not exist, it will be created")
    p.add_argument("-p", "--proportion-repeat", type=float, default=0.8, help="proportion of read that is repetitive to be considered as STR")
    p.add_argument("-q", "--min-mapq", type=int, default=40, help="minimum mapping quality (does not apply to STR reads)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile", default="", help="write a torch.profiler trace of extract to this directory; it shows the engine's producer and inflate threads beside the card's stream")
    _add_device(p)
    p.add_argument("--devices", default="", help="with --device cuda: 'all' or a count of local GPUs to round-robin scan batches over (output is byte-identical)")
    p.add_argument("--distributed", action="store_true",
                   help="shard chromosomes over torch.distributed ranks (launch with torchrun; one rank a device); rank 0 writes the bin")
    p.add_argument("bam", help="path to bam file")
    p.add_argument("bin", help="path to output bin file to be created")
    args = p.parse_args(argv)

    from strling_tpu_torch.core.extract import extract_native, scan_devices
    from strling_tpu_torch.io import Bam, write_bin
    from strling_tpu_torch.utils.profiling import maybe_trace

    if args.distributed:
        if args.devices:
            raise SystemExit("--devices does not apply to --distributed: "
                             "each rank scans on its own device")
        from strling_tpu_torch.parallel.extract_dist import run_extract_dist
        from strling_tpu_torch.parallel.mesh import init_distributed

        run_extract_dist(
            args.bam, args.fasta or None, args.genome_repeats or None,
            proportion_repeat=args.proportion_repeat, min_mapq=args.min_mapq,
            output_bin=args.bin, verbose=args.verbose,
            device=init_distributed(args.device),
        )
        print("[strling] finished extraction", file=sys.stderr)
        return

    devs = scan_devices(args.device, args.devices or None)
    bam = Bam(args.bam, fasta=args.fasta or None)
    with maybe_trace(args.profile or None, "extract"):
        treads, frag_dist, _ = extract_native(
            bam, args.fasta or None, args.genome_repeats or None,
            proportion_repeat=args.proportion_repeat, min_mapq=args.min_mapq,
            verbose=args.verbose, devices=devs,
        )
    print(f"[strling] writing binary file:{args.bin}", file=sys.stderr)
    write_bin(args.bin, treads, frag_dist, bam.header_text,
              args.proportion_repeat, args.min_mapq)
    print("[strling] finished extraction", file=sys.stderr)


def _index(argv):
    p = argparse.ArgumentParser("strling index")
    p.add_argument("-g", "--genome-repeats", default="", help="optional path to output genome repeats file (default: ./<FASTA>.str)")
    p.add_argument("-p", "--proportion-repeat", type=float, default=0.8)
    _add_device(p)
    p.add_argument("fasta", help="path to fasta file")
    args = p.parse_args(argv)

    from strling_tpu_torch.core.extract import scan_devices
    from strling_tpu_torch.core.genome_index import genome_repeats
    from strling_tpu_torch.utils.options import Options

    dev = scan_devices(args.device)[0]
    out = args.genome_repeats or (os.path.basename(args.fasta) + ".str")
    print(f"Writing genome str index to: {out}", file=sys.stderr)
    genome_repeats(args.fasta, Options(proportion_repeat=args.proportion_repeat),
                   out, dev)


def _call(argv):
    from strling_tpu_torch.core.call import call_main

    call_main(argv)


def _merge(argv):
    from strling_tpu_torch.core.merge import merge_main

    merge_main(argv)


def _outliers(argv):
    from strling_tpu_torch.core.outliers import outliers_main

    outliers_main(argv)


def _pull_region(argv):
    from strling_tpu_torch.core.pull_region import pull_region_main

    pull_region_main(argv)


def _simulate(argv):
    from strling_tpu_torch.core.simulate import simulate_main

    simulate_main(argv)


COMMANDS = {
    "extract": (_extract, "extract informative STR reads from a BAM/CRAM. This is a required first step."),
    "merge": (_merge, "merge putative STR loci from multiple samples. Only required for joint calling."),
    "call": (_call, "call STRs"),
    "index": (_index, "identify large STRs in the reference genome, to produce ref.fasta.str."),
    "pull_region": (_pull_region, "for debugging; pull all reads (and mates) for a given region"),
    "outliers": (_outliers, "cohort-level outlier statistics across many samples"),
    "simulate": (_simulate, "simulate paired reads with STR expansions"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(f"\nstrling version: {__version__} (strling_tpu_torch)", file=sys.stderr)
    if not argv or argv[0] not in COMMANDS:
        print("\nCommands: ", file=sys.stderr)
        for k, (_, desc) in COMMANDS.items():
            print(f"  {k:<13}:   {desc}")
        if argv and argv[0] in ("-h", "--help"):
            return 0
        if argv:
            print(f"unknown program '{argv[0]}'")
        raise SystemExit("ERROR: please enter a valid command")
    COMMANDS[argv[0]][0](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
