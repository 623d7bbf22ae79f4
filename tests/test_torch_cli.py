"""The port's training CLI (m3p_tpu_torch.cli.train_x) against the JAX
package's: the parser and `args_to_config` over the reference recipes, then
`main` end to end on the CPU from datasets the JAX loader builds (train,
evaluate, checkpoint, resume with ``--eval_only``), the weight reloads, and
what `main` refuses."""

import os
import pickle

import numpy as np
import pytest
import torch

from m3p_tpu.cli import train_x as jax_cli
from m3p_tpu.data.features import write_feature_shard
from m3p_tpu.data.loader import load_data as jax_load_data
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu_torch import checkpoint as ckpt
from m3p_tpu_torch.cli import train_x
from m3p_tpu_torch.data.loader import LoadedData
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

torch.set_num_threads(1)

# tests/test_cli.py: test_parser_accepts_reference_recipe
README_RECIPE = [
    "--data_path", "/tmp/data", "--lgs", "en-de-fr-cs",
    "--emb_dim", "768", "--n_layers", "12", "--n_heads", "12",
    "--cross_rel_steps", "coco-img", "--batch_size", "24",
    "--accumulate_gradients", "4", "--max_len", "64",
    "--max_region_num", "100", "--fp16", "True", "--amp", "1",
    "--optimizer", "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005",
    "--epoch_size", "150000", "--max_epoch", "150",
    "--stopping_criterion", "valid_mean_recall,10",
    "--validation_metrics", "valid_mean_recall",
    "--sample_n", "4", "--refine_image", "True",
    "--local_rank", "0", "--master_port", "9999",
]
# tests/test_cli.py: test_full_reference_mscoco_recipe_parses
MSCOCO_RECIPE = [
    "--data_path", "/d", "--reload_model", "/m.pth",
    "--dump_path", "/out", "--exp_name", "e",
    "--batch_size", "24", "--emb_dim", "768", "--n_layers", "12",
    "--n_heads", "12", "--n_dec_layers", "-1", "--dropout", "0.1",
    "--attention_dropout", "0.1", "--gelu_activation", "True",
    "--optimizer", "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005",
    "--lgs", "en-de-fr", "--vocab_path", "/v",
    "--google_path", "google_captions/obj100",
    "--sbu_path", "google_captions/obj100",
    "--coco_path", "coco", "--flicker_path", "flicker",
    "--cross_rel_steps", "coco-img", "--mlm_steps", "",
    "--epoch_size", "150000", "--max_epoch", "150", "--bptt", "128",
    "--max_len", "64", "--fp16", "True",
    "--validation_metrics", "valid_I2T_acc,valid_T2I_acc",
    "--max_region_num", "100", "--accumulate_gradients", "4",
    "--amp", "1", "--refine_image", "False",
    "--refine_encoder", "False", "--input_fea_dir", "/fea",
    "--save_every_epoch", "5", "--is_generation", "False",
    "--is_understanding", "True", "--is_pretrain", "False",
    "--use_new_fea", "True", "--t2i_flag", "True", "--i2t_flag", "True",
    "--eval_n", "50", "--sent_ratio", "0.8", "--word_ratio", "0.8",
    "--seq_per_img", "5", "--eval_images", "-1", "--sample_n", "4",
    "--multi_cls_loss_weight", "0", "--bin_cls_loss_weight", "1",
    "--num_workers", "4", "--eval_path", "/ev",
    "--google_valid_path", "/cc", "--train_order_path", "/ord",
    "--cross_lingual_path", "/cl", "--ft_lgs", "en", "--src_lgs", "en",
    "--ag_lgs", "", "--eval_only", "False", "--is_freelb", "False",
]
MORE = [
    ["--is_pretrain", "True", "--cross_rel_steps", "coco-img",
     "--cross_clcm_steps", "coco-img", "--mlm_steps", "en,de",
     "--lgs", "en-de", "--lambda_mlm", "0:1,1000:0.5", "--is_freelb", "1",
     "--adv_steps", "2", "--mesh_seq", "2", "--pp_stages", "2"],
    ["--is_ntg", "True", "--mt_steps", "en-de", "--is_slide", "on",
     "--cross_rel_steps", "ppt", "--cross_gan_steps", "coco-img",
     "--cross_ae_steps", "coco-img", "--tokens_per_batch", "2000",
     "--max_batch_size", "16", "--max_len", "32", "--fp16", "off"],
    ["--optimizer", "sgd,lr=0.1,momentum=0.9", "--clip_grad_norm", "0",
     "--eval_quant", "int8", "--fast_beam", "1", "--beam_size", "5",
     "--coco_method", "Bleu,METEOR", "--use_noise", "0.1", "--seed", "7"],
]


@pytest.mark.parametrize("argv", [README_RECIPE, MSCOCO_RECIPE] + MORE,
                         ids=["readme", "mscoco", "pretrain", "ntg_slide",
                              "sgd_eval"])
def test_args_to_config_is_the_jax_config(argv):
    want = jax_cli.args_to_config(jax_cli.get_parser().parse_args(argv))
    got = train_x.args_to_config(train_x.get_parser().parse_args(argv))
    assert got.to_json() == want.to_json()


def test_parser_has_every_jax_flag_and_default():
    want = vars(jax_cli.get_parser().parse_args([]))
    got = vars(train_x.get_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A data directory as `tests/test_cli.py::test_train_x_main_end_to_end`
    writes it, loaded by the JAX loader: the port has no loader yet
    (item 13), so `main` takes its datasets."""
    tmp = tmp_path_factory.mktemp("cli")
    vocab = str(tmp / "vocab.tsv")
    train_unigram(["red cat dog runs blue tree house"] * 30,
                  vocab_size=80).save(vocab)
    rng = np.random.RandomState(0)
    root = tmp / "coco"
    root.mkdir()
    n, r = 6, 4
    write_feature_shard(
        str(root / "train.h5"),
        features=rng.randn(n, r, 2048).astype(np.float32),
        boxes=np.abs(rng.rand(n, r, 4)).astype(np.float32) * 50,
        num_boxes=np.full(n, r, np.int64), wh=np.full((n, 2), 100, np.float32),
        image_ids=[f"i{k}" for k in range(n)],
        objects=rng.randint(0, 1600, (n, r)))
    caps = {f"i{k}": ["red cat runs", "blue dog tree"] for k in range(n)}
    for split in ("train", "test"):
        with open(root / f"{split}.en.pkl", "wb") as f:
            pickle.dump(caps, f)
    argv = [
        "--data_path", str(tmp), "--vocab_path", vocab, "--lgs", "en",
        "--cross_rel_steps", "coco-img", "--max_region_num", str(r),
        "--sample_n", "2", "--batch_size", "2", "--max_len", "12",
        "--emb_dim", "32", "--n_layers", "1", "--n_dec_layers", "1",
        "--n_heads", "2", "--refine_layers", "1", "--dropout", "0.0",
        "--attention_dropout", "0.0", "--fp16", "False",
        "--epoch_size", "4", "--max_epoch", "1", "--use_grain", "False",
        "--accumulate_gradients", "2",
        "--validation_metrics", "valid_mean_recall",
        "--dump_path", str(tmp / "dump"), "--exp_name", "t",
    ]
    jdata = jax_load_data(jax_cli.args_to_config(
        jax_cli.get_parser().parse_args(argv)))
    data = LoadedData(train_datasets=jdata.train_datasets,
                      eval_data=jdata.eval_data,
                      tokenizer=XLMRTokenizer(vocab))
    return {"argv": argv, "data": data, "dump": tmp / "dump" / "t",
            "tmp": tmp}


def _scores(log_path):
    with open(log_path) as f:
        return [line.split("__log__:", 1)[1].strip() for line in f
                if "__log__:" in line]


def test_main_trains_evaluates_and_resumes(coco):
    argv = coco["argv"] + ["--exp_id", "run", "--device", "cpu"]
    trainer = train_x.main(argv, data=coco["data"])
    dump = coco["dump"] / "run"
    assert trainer.epoch == 1 and trainer.n_total_iter == 2
    assert trainer.state.step == 2            # 4 micro-steps, k = 2
    assert trainer.cfg.model.n_words == coco["data"].tokenizer.vocab_size
    names = set(os.listdir(dump))
    assert {"checkpoint", "best-mean_recall", "params.json",
            "train.log"} <= names
    scores = _scores(dump / "train.log")
    assert len(scores) == 1 and "mean_recall" in scores[0]
    again = train_x.main(argv + ["--eval_only", "True"], data=coco["data"])
    assert again.epoch == 1 and again.state.step == 2
    with open(dump / "train.log") as f:
        assert "resumed from" in f.read()
    for name, p in again.model.state_dict().items():
        assert torch.equal(p, trainer.model.state_dict()[name]), name
    after = _scores(dump / "train.log")
    assert len(after) == 2 and after[1] == after[0]


def test_main_reloads_weights(coco):
    cfg = train_x.args_to_config(train_x.get_parser().parse_args(
        coco["argv"]))
    other_lgs = cfg.model.__class__(
        **{**cfg.model.__dict__, "n_langs": cfg.model.n_langs + 3})
    paths = []
    for seed in (11, 12, 13):
        paths.append(str(coco["tmp"] / f"ref{seed}.pth"))
        ckpt.save_reference_checkpoint(
            paths[-1], build_model(other_lgs, seed, "cpu"),
            cfg.model.n_layers, cfg.model.refine_layers)
    base = coco["argv"] + ["--device", "cpu", "--max_epoch", "0"]
    t = train_x.main(base + ["--exp_id", "pth", "--reload_model", paths[0]],
                     data=coco["data"])
    init = build_model(t.cfg.model, t.cfg.seed, "cpu").state_dict()
    ref = ckpt.load_reference_file(paths[0], cfg.model.n_layers,
                                   cfg.model.refine_layers)
    got = t.model.state_dict()
    assert torch.equal(got["text_emb.lang.weight"],
                       init["text_emb.lang.weight"])
    assert torch.equal(got["block_0.ffn.lin1.weight"],
                       ref["block_0.ffn.lin1.weight"])
    blend = train_x.main(base + ["--exp_id", "blend", "--reload_model",
                                 paths[0], "--multi_reload_model",
                                 ",".join(paths[1:])], data=coco["data"])
    refs = [ckpt.load_reference_file(p, cfg.model.n_layers,
                                     cfg.model.refine_layers) for p in paths]
    want = 0.6 * refs[0]["block_0.ffn.lin1.weight"] + 0.4 * (
        0.5 * refs[1]["block_0.ffn.lin1.weight"]
        + 0.5 * refs[2]["block_0.ffn.lin1.weight"])
    torch.testing.assert_close(
        blend.model.state_dict()["block_0.ffn.lin1.weight"], want,
        rtol=1e-6, atol=1e-7)
    saved = coco["dump"] / "pth" / "checkpoint"
    t.save_checkpoint()
    from_dir = train_x.main(base + ["--exp_id", "dir", "--reload_model",
                                    str(saved)], data=coco["data"])
    for name, p in from_dir.model.state_dict().items():
        assert torch.equal(p, got[name]), name


def test_main_refuses_what_is_not_ported(coco, monkeypatch):
    argv = coco["argv"] + ["--exp_id", "refuse"]
    with pytest.raises(NotImplementedError, match="item 13"):
        train_x.main(argv + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_x.main(argv, data=coco["data"])
    # two visible cards and a batch that shards over them
    import m3p_tpu_torch.model as model_mod

    monkeypatch.setattr(model_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 16"):
        train_x.main(argv, data=coco["data"])


def test_main_says_when_one_of_several_cards_runs(coco, monkeypatch):
    # two visible cards and a batch of 3 that does not shard over them:
    # one card runs, and the log says so before the model is built
    import m3p_tpu_torch.model as model_mod

    class Built(Exception):
        pass

    def build_model(*args, **kw):
        raise Built

    monkeypatch.setattr(model_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(model_mod, "build_model", build_model)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    argv = coco["argv"] + ["--exp_id", "one_card", "--batch_size", "3"]
    with pytest.raises(Built):
        train_x.main(argv, data=coco["data"])
    with open(coco["dump"] / "one_card" / "train.log") as f:
        text = f.read()
    assert "batch_size 3 not divisible by data*fsdp=2" in text
    assert "running on one card of 2" in text
