"""Model server CLI of the port: load a checkpoint and serve ITM scoring,
retrieval, captioning and translation over HTTP (counterpart of
`m3p_tpu/cli/serve.py`)::

    python -m m3p_tpu_torch.cli.serve --reload_model model.pth \\
        --vocab_path vocab.tsv --lgs en-de --device cuda --port 8470 \\
        --beam_size 5 --max_gen_len 20 --length_penalty 1.0 \\
        --features_path test.h5 --load_gallery 1000 --quant int8

    curl -s localhost:8470/health
    curl -s -X POST localhost:8470/v1/score \\
        -d '{"pairs": [{"text": "a dog", "feats": [[...]], "locs": [[...]]}]}'
    curl -s -X POST localhost:8470/v1/caption \\
        -d '{"images": [{"feats": [[...]], "locs": [[...]]}]}'
    curl -s -X POST localhost:8470/v1/translate \\
        -d '{"texts": ["a dog"], "src_lang": "en", "tgt_lang": "de"}'
    curl -s -X POST localhost:8470/v1/retrieve \\
        -d '{"text": "a dog on a beach", "top_k": 5}'

The decoding flags set the engine's defaults; a /v1/caption or
/v1/translate request may override ``beam_size`` and ``max_len``.
``--features_path`` attaches an h5 region-feature shard for ``image_id``
payloads, ``--load_gallery N`` stages its first N images as the retrieval
gallery, and ``--quant int8`` serves the checkpoint through the
frozen-weight int8 GEMMs.  ``--device`` picks the torch device (the JAX
CLI's ``--platform``).
"""

from __future__ import annotations

import argparse
import logging


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("m3p_tpu_torch model server")
    p.add_argument("--reload_model", type=str, required=True,
                   help="reference .pth, or a .pt state dict saved by the "
                        "port")
    p.add_argument("--vocab_path", type=str, required=True,
                   help="SentencePiece .spm or in-tree TSV vocab")
    p.add_argument("--emb_dim", type=int, default=768)
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--n_dec_layers", type=int, default=0,
                   help="decoder depth (0 = same as --n_layers)")
    p.add_argument("--n_heads", type=int, default=12)
    p.add_argument("--max_region_num", type=int, default=100)
    p.add_argument("--refine_layers", type=int, default=3)
    p.add_argument("--refine_image", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--lgs", type=str, default="en",
                   help="language list, e.g. en-de-fr (order fixes lang ids)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   help="compute dtype: bfloat16 or float32")
    p.add_argument("--quant", type=str, default="none",
                   help="'int8' = frozen-weight int8 serving: the GEMM "
                        "weights quantize once at load (same checkpoint; a "
                        "small score perturbation)")
    # data / gallery
    p.add_argument("--features_path", type=str, default="",
                   help="h5 region-feature shard for image_id payloads")
    p.add_argument("--load_gallery", type=int, default=0,
                   help="stage the first N store images as the retrieval "
                        "gallery (0 = don't)")
    # decoding defaults
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--max_gen_len", type=int, default=20)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the "
                        "kernels")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8470)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--batch_wait_ms", type=float, default=5.0)
    p.add_argument("--warmup", type=lambda s: s.lower() != "false",
                   default=True, help="build the kernel and run one pass "
                                      "before serving")
    return p


def main(argv=None, store=None, serve: bool = True):
    """Parse ``argv``, build the engine and serve until stopped.  ``store``
    (any object with `data.features.RegionFeatureStore`'s methods) stands
    in for ``--features_path``; with ``serve=False`` the engine is returned
    before the server starts."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from m3p_tpu_torch.config import ModelConfig, parse_lgs
    from m3p_tpu_torch.serve.engine import InferenceEngine
    from m3p_tpu_torch.serve.server import serve_forever
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    tokenizer = XLMRTokenizer(args.vocab_path)
    lang2id = parse_lgs(args.lgs)
    cfg = ModelConfig(
        n_words=tokenizer.vocab_size, mask_index=tokenizer.mask_token_id,
        n_layers=args.n_layers,
        n_dec_layers=args.n_dec_layers or args.n_layers,
        emb_dim=args.emb_dim, n_heads=args.n_heads,
        n_langs=max(len(lang2id) + 1, 2), dropout=0.0, attention_dropout=0.0,
        max_region_num=args.max_region_num,
        refine_layers=args.refine_layers, dtype=args.dtype)
    engine = InferenceEngine.from_checkpoint(
        args.reload_model, cfg, tokenizer=tokenizer, quant=args.quant,
        device=args.device, refine_image=args.refine_image,
        beam_size=args.beam_size, max_gen_len=args.max_gen_len,
        length_penalty=args.length_penalty, lang2id=lang2id)
    if store is not None:
        engine.store = store
    elif args.features_path:
        engine.attach_store(args.features_path)
    if args.load_gallery:
        n = engine.load_gallery_from_store(limit=args.load_gallery)
        logging.getLogger("m3p_tpu_torch").info("gallery: %d images", n)
    if args.warmup:
        engine.warmup()
    if not serve:
        return engine
    serve_forever(engine, args.host, args.port, max_batch=args.max_batch,
                  max_wait_s=args.batch_wait_ms / 1000.0)
    return engine


if __name__ == "__main__":
    main()
