#!/usr/bin/env python
"""Carry a production proof's run directory from one machine to the next
within a size limit: what `scripts/prove_production_torch.py` needs to
resume (`--load latest` and the journal-rebuilt replay) and to play its
verdict.

  python tools/run_carry.py pack OUT ARCHIVE
  python tools/run_carry.py unpack ARCHIVE OUT

`pack` writes one uncompressed tar: the small files (progress.json, the
status curve, the eval ladder, the promotion log, final.json), the server's
log (the verdict reads its decisions), ckpt/latest and the checkpoint it
names, every promoted-<ver>.bin without its optimizer slots (the anchor
reads the weights and BN statistics alone), and the record journal as one
xz stream (`journal.jsonl.xz`, chunks in order).  If that is larger than
52 MiB, the journal's oldest records are left out until it fits, and
the tar says how many (`carry.json`).  init.bin is not carried: the run's
frozen init is a file of the repository.  `unpack` restores the
directory, the journal as `ckpt/journal/records-0.jsonl`.  Prints one
JSON line either way.
"""

import argparse
import io
import json
import lzma
import os
import sys
import tarfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the archive and the run's gzipped logs and small files are brought back
# together within 64 MiB
LIMIT_MB = 52.0
SMALL = ("progress.json", "status_curve.jsonl", "eval_ladder.txt",
         "final.json", "server.log", "ckpt/promotions.jsonl")


def journal_lines(out):
    jdir = os.path.join(out, "ckpt", "journal")
    if not os.path.isdir(jdir):
        return []
    chunks = sorted(
        (int(f[len("records-"):-len(".jsonl")]), f) for f in os.listdir(jdir)
        if f.startswith("records-") and f.endswith(".jsonl"))
    lines = []
    for _, f in chunks:
        with open(os.path.join(jdir, f), "rb") as fh:
            lines += [l for l in fh if l.strip().endswith(b"}")]
    return lines


def pack(out, archive, limit_mb=LIMIT_MB):
    from elf_tpu_torch.models import checkpoint

    files = [f for f in SMALL if os.path.isfile(os.path.join(out, f))]
    weights = {}
    for f in sorted(os.listdir(out)):
        if f.startswith("promoted-") and f.endswith(".bin"):
            tree = checkpoint.read_checkpoint(os.path.join(out, f))
            weights[f] = checkpoint.msgpack_serialize(
                {k: tree[k] for k in ("params", "batch_stats", "step")})
    latest = os.path.join(out, "ckpt", "latest")
    if os.path.islink(latest):
        files += ["ckpt/latest", "ckpt/" + os.readlink(latest)]
    fixed = sum(os.path.getsize(os.path.join(out, f)) for f in files
                if not os.path.islink(os.path.join(out, f)))
    fixed += sum(len(w) for w in weights.values())
    lines = journal_lines(out)
    limit = int(limit_mb * 2 ** 20) - 2 ** 20       # tar headers, carry.json
    keep, blob = len(lines), b""
    while keep:
        blob = lzma.compress(b"".join(lines[len(lines) - keep:]), preset=3)
        if fixed + len(blob) <= limit:
            break
        keep = int(keep * (limit - fixed) / len(blob) * 0.97)
        keep = max(keep, 0)
    if not keep:
        blob = b""
    meta = {"records": len(lines), "records_kept": keep,
            "journal_xz_bytes": len(blob), "files": files + list(weights)}
    with tarfile.open(archive, "w") as tar:
        for f in files:
            tar.add(os.path.join(out, f), arcname=f)
        for name, data in (*weights.items(), ("journal.jsonl.xz", blob),
                           ("carry.json", json.dumps(meta).encode())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    meta["archive_bytes"] = os.path.getsize(archive)
    return meta


def unpack(archive, out):
    with tarfile.open(archive) as tar:
        tar.extractall(out, filter="tar")
    meta = json.load(open(os.path.join(out, "carry.json")))
    jdir = os.path.join(out, "ckpt", "journal")
    os.makedirs(jdir, exist_ok=True)
    src = os.path.join(out, "journal.jsonl.xz")
    with open(src, "rb") as f:
        blob = f.read()
    with open(os.path.join(jdir, "records-0.jsonl"), "wb") as f:
        f.write(lzma.decompress(blob) if blob else b"")
    os.remove(src)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=("pack", "unpack"))
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    if args.cmd == "pack":
        meta = pack(args.src, args.dst)
    else:
        meta = unpack(args.src, args.dst)
    print(json.dumps(meta), flush=True)


if __name__ == "__main__":
    sys.exit(main())
