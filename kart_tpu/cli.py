"""kart-tpu command line, flag-compatible with the reference aligner.

Subcommands/flags (reference: src/main.cpp:87-214):
  kart-tpu index ref.fa prefix
  kart-tpu -i prefix -f r1 [...] [-f2 r2 [...]] [-o out.sam | -bo out.bam]
           [-t N] [-g N] [-m] [-p] [-pacbio] [-silent] [-d]
"""

from __future__ import annotations

import os
import sys
import time

VERSION = "2.5.6"  # behavior-parity version of the reference CLI


def usage(prog: str) -> None:
    print(f"kart-tpu v{VERSION} (JAX reimplementation of Kart)\n")
    print(
        f"Usage: {prog} -i Index_Prefix -f <ReadFile_A1 ReadFile_B1 ...>"
        " [-f2 <ReadFile_A2 ReadFile_B2 ...>] -o Output\n"
    )
    print("Options: -t INT        number of threads [4]")
    print("         -f            files with #1 mates reads (format:fa, fq, fq.gz)")
    print("         -f2           files with #2 mates reads (format:fa, fq, fq.gz)")
    print("         -o            alignment filename in SAM format [output.sam]")
    print("         -bo           alignment filename in BAM format")
    print("         -m            output multiple alignments")
    print("         -g INT        max gaps (indels) [5]")
    print("         -p            paired-end reads are interlaced in the same file")
    print("         -pacbio       pacbio data")
    print("         -cpu          map on the host only (no accelerator)")
    print("         -idx-shards N shard the FM-index over N mesh devices")
    print("                       (for indexes too big for one device's memory)")
    print("         -v            version\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "kart-tpu"
    args = argv[1:]

    if not args or args[0] == "-h":
        usage(prog)
        return 0
    if args[0] == "update":
        # reference: `git fetch; git merge origin/master master; make`
        # (src/main.cpp:107-111) — self-update from the repository
        import subprocess

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        rc = subprocess.call(["git", "-C", root, "pull", "--ff-only"])
        return rc
    if args[0] == "index":
        if len(args) == 3:
            from .index import build_index

            build_index(args[1], args[2])
            return 0
        print(f"usage: {prog} index ref.fa prefix", file=sys.stderr)
        return 1

    max_gaps = 5
    threads = 4
    pair_end = False
    pacbio = False
    multi_hit = False
    silent = False
    debug = False
    use_device = True
    backend = "native"
    idx_shards = int(os.environ.get("KART_IDX_SHARDS", "0"))
    out_name = "output.sam"
    out_format = 0
    index_name = None
    files1: list[str] = []
    files2: list[str] = []

    i = 0
    while i < len(args):
        p = args[i]
        if p == "-i":
            i += 1
            index_name = args[i]
        elif p == "-f":
            while i + 1 < len(args) and not args[i + 1].startswith("-"):
                i += 1
                files1.append(args[i])
        elif p == "-f2":
            while i + 1 < len(args) and not args[i + 1].startswith("-"):
                i += 1
                files2.append(args[i])
        elif p == "-t" and i + 1 < len(args):
            i += 1
            threads = int(args[i])
            if threads <= 0:
                print("Warning! Thread number should be a positive number!")
                threads = 4
        elif p == "-g":
            i += 1
            max_gaps = max(0, int(args[i]))
        elif p == "-o":
            i += 1
            out_format = 0
            out_name = args[i]
        elif p == "-bo":
            i += 1
            out_format = 1
            out_name = args[i]
        elif p == "-silent":
            silent = True
        elif p == "-pacbio":
            pacbio = True
        elif p == "-m":
            multi_hit = True
        elif p in ("-p", "-pair"):
            pair_end = True
        elif p in ("-d", "-debug"):
            debug = True
        elif p == "-cpu":
            use_device = False
        elif p == "-idx-shards" and i + 1 < len(args):
            i += 1
            idx_shards = int(args[i])
        elif p == "-backend" and i + 1 < len(args):
            # undocumented: native (default) | python — force the pipeline
            # implementation (python exercises the device kernels end-to-end)
            i += 1
            backend = args[i]
        elif p in ("-v", "--version"):
            print(f"kart-tpu v{VERSION}\n")
            return 0
        else:
            print(f"Error! Unknown parameter: {p}")
            usage(prog)
            return 1
        i += 1

    if not files1:
        print("Error! Please specify a valid read input!")
        usage(prog)
        return 1
    if files2 and len(files1) != len(files2):
        print("Error! Paired-end reads input numbers do not match!")
        return 1
    for f in files1 + files2:
        if not os.path.exists(f):
            print(f"Cannot access file:[{f}]")
            return 0
    if index_name is None:
        print("Error! Please specify a valid reference index!")
        usage(prog)
        return 1

    from .index import index_files_exist, load_index

    if not index_files_exist(index_name):
        print("Error! Please specify a valid reference index!")
        return 1

    print("Load the genome index files...")
    gidx = load_index(index_name)
    print("Load the reference sequences...")

    from .io.fastq import check_read_format
    from .pipeline.mapper import KartMapper
    from .pipeline.sam import sam_header

    if debug:
        threads = 1  # reference: debug mode forces one thread (Mapping.cpp:648)
    mapper = KartMapper(
        gidx,
        pacbio=pacbio,
        max_gaps=max_gaps,
        multi_hit=multi_hit,
        use_device=use_device,
        backend=backend,
        n_threads=threads,
        debug=debug,
        idx_shards=idx_shards,
    )

    if out_format == 0:
        out_f = open(out_name, "wb")

        def writer(s):
            out_f.write(s if isinstance(s, bytes) else s.encode("ascii"))

        closer = out_f.close
    else:
        from .io.bam import BamWriter

        bw = BamWriter(out_name, gidx, version=VERSION)

        def writer(s):
            bw.write_sam_text(s.decode("ascii") if isinstance(s, bytes) else s)

        closer = bw.close
    writer(sam_header(gidx, VERSION))

    t0 = time.time()
    sep_library = len(files2) == len(files1) and len(files2) > 0
    for lib in range(len(files1)):
        fastq = check_read_format(files1[lib])
        path2 = None
        lib_pair = pair_end
        if sep_library:
            lib_pair = True
            if fastq != check_read_format(files2[lib]):
                print(f"Error! {files1[lib]} and {files2[lib]} are with different format...")
                continue
            path2 = files2[lib]

        progress = None
        if not silent:
            kind = "paired-end" if lib_pair else "singled-end"

            def progress(total, kind=kind):
                print(
                    f"\r{total} {kind} reads have been processed"
                    f" in {int(time.time() - t0)} seconds...",
                    end="",
                    flush=True,
                )

        mapper.map_stream(files1[lib], path2, lib_pair, fastq, writer, progress)
    closer()

    st = mapper.stats
    total = st["total"]
    print(
        f"\rAll the {total} {'paired-end' if (pair_end or sep_library) else 'single-end'} reads"
        f" have been processed in {int(time.time() - t0)} seconds."
    )
    if total > 0:
        mapped = total - st["unmapped"]
        sens = int(10000 * (mapped / total) + 0.5) / 100.0
        if pair_end or sep_library:
            pct = int(10000 * (st["paired"] / total) + 0.5) / 100.0
            avg = st["distance"] // (st["paired"] >> 1) if st["paired"] > 1 else 0
            print(
                f"\t# of total mapped sequences = {mapped} (sensitivity = {sens:.2f}%)\n"
                f"\t# of paired sequences = {st['paired']} ({pct:.2f}%), average insert size = {avg}"
            )
        else:
            print(f"\t# of total mapped sequences = {mapped} (sensitivity = {sens:.2f}%)")
        print(f"Alignment output: {out_name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
