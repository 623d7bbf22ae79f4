"""Offline preprocessing CLI of the port (counterpart of
`m3p_tpu/cli/preprocess.py`): vocabulary training and the binarizer.

Subcommands:
  train-vocab -- train a unigram vocabulary from text corpora into a TSV
                 (``--impl auto|native|python``; ``auto`` is the native
                 trainer and, like ``native``, raises if it cannot be
                 built; the two give the same model piece for piece)
  binarize    -- tokenize text files into one flat int32 token stream
                 (.npy), each sentence ended by </s>, at most 512 ids a
                 sentence
  spm-to-tsv  -- convert a SentencePiece .spm/.model protobuf to the TSV
                 the native encoder reads

Usage:
  python -m m3p_tpu_torch.cli.preprocess train-vocab --out vocab.tsv \\
      --size 32000 corpus1.txt corpus2.txt
  python -m m3p_tpu_torch.cli.preprocess binarize --vocab vocab.tsv \\
      --out train.en.npy train.en.txt
  python -m m3p_tpu_torch.cli.preprocess spm-to-tsv model.spm \\
      --out vocab.tsv
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Optional

import numpy as np

from m3p_tpu_torch.config import EOS_IDX

BINARIZE_BATCH = 2048
BINARIZE_MAX_IDS = 512


def cmd_train_vocab(args) -> None:
    if args.impl in ("auto", "native"):
        from m3p_tpu_torch.tokenization.native import native_train_unigram

        n = native_train_unigram(args.inputs, args.out, vocab_size=args.size)
        print(f"trained unigram vocab (native): {n} pieces -> {args.out}")
        return

    from m3p_tpu_torch.tokenization.unigram import train_unigram

    def lines() -> Iterator[str]:
        for path in args.inputs:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    yield line.rstrip("\n")

    model = train_unigram(lines(), vocab_size=args.size)
    model.save(args.out)
    print(f"trained unigram vocab: {len(model)} pieces -> {args.out}")


def cmd_binarize(args) -> None:
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    tok = XLMRTokenizer(args.vocab)
    stream: List[int] = []
    n_sents = 0

    def flush(batch: List[str]) -> None:
        nonlocal n_sents
        for ids in tok.encode_batch(batch, max_ids=BINARIZE_MAX_IDS):
            stream.extend(ids)
            stream.append(EOS_IDX)
            n_sents += 1

    for path in args.inputs:
        with open(path, encoding="utf-8") as f:
            batch: List[str] = []
            for line in f:
                batch.append(line.rstrip("\n"))
                if len(batch) == BINARIZE_BATCH:
                    flush(batch)
                    batch = []
            flush(batch)
    arr = np.asarray(stream, np.int32)
    np.save(args.out, arr)
    print(f"binarized {n_sents} sentences, {arr.size} tokens -> {args.out}")


def cmd_spm_to_tsv(args) -> None:
    from m3p_tpu_torch.tokenization.unigram import UnigramModel

    model = UnigramModel.from_spm(args.input)
    model.save(args.out)
    n_match = len(model.piece_to_id)
    print(f"converted {len(model)} pieces ({n_match} matchable) -> {args.out}")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="m3p_tpu_torch preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    tv = sub.add_parser("train-vocab")
    tv.add_argument("inputs", nargs="+")
    tv.add_argument("--out", required=True)
    tv.add_argument("--size", type=int, default=32000)
    tv.add_argument("--impl", choices=("auto", "native", "python"),
                    default="auto")
    tv.set_defaults(fn=cmd_train_vocab)

    bz = sub.add_parser("binarize")
    bz.add_argument("inputs", nargs="+")
    bz.add_argument("--vocab", required=True)
    bz.add_argument("--out", required=True)
    bz.set_defaults(fn=cmd_binarize)

    sp = sub.add_parser("spm-to-tsv")
    sp.add_argument("input")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_spm_to_tsv)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
