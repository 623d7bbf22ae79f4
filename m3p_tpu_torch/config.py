"""Configuration of the PyTorch port.

A copy of `m3p_tpu/config.py`, field for field: the constants,
`ModelConfig`, `OptimConfig`, `MeshConfig`, `DataConfig`, `EvalConfig`,
`TrainConfig` and the three presets, so a JAX config converts with
``ModelConfig(**dataclasses.asdict(c))``.  The port keeps its own copy: it
imports nothing of the JAX package.  Like the JAX module it imports neither
torch nor numpy.

String micro-DSLs kept from the reference's flags:
  * task steps:      ``"coco-img,flicker-img"``  -> list of (dataset, modality)
  * lambda schedule: ``"0:1,1000:0"``            -> piecewise-linear coefficient
  * optimizer spec:  ``"adam_inverse_sqrt,beta1=0.9,lr=0.0001"``
  * languages:       ``"en-de-fr-cs"``           -> lang2id mapping
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# fairseq / XLM-R special-token ids: <s>=0 <pad>=1 </s>=2 <unk>=3
BOS_IDX = 0
PAD_IDX = 1
EOS_IDX = 2
UNK_IDX = 3

N_OBJ_CLASSES = 1600
IMG_FEAT_DIM = 2048
IMG_LOC_DIM = 5

N_MAX_POSITIONS = 514


def parse_lgs(lgs: str) -> Dict[str, int]:
    """``"en-de-fr-cs"`` -> ``{"en":0, "de":1, "fr":2, "cs":3}``."""
    seen: List[str] = []
    for lang in lgs.split("-"):
        if lang and lang not in seen:
            seen.append(lang)
    return {lang: i for i, lang in enumerate(seen)}


def parse_steps(steps: str) -> List[Tuple[str, Optional[str]]]:
    """``"coco-img,mild"`` -> ``[("coco","img"), ("mild",None)]``."""
    out: List[Tuple[str, Optional[str]]] = []
    for item in [s for s in steps.split(",") if s]:
        if "-" in item:
            a, b = item.split("-", 1)
            out.append((a, b))
        else:
            out.append((item, None))
    return out


@dataclass(unsafe_hash=True)
class ModelConfig:
    """Architecture of the M3P encoder (defaults: 12L / 768d / 12H)."""

    n_words: int = 250002
    n_langs: int = 5
    emb_dim: int = 768
    n_layers: int = 12
    n_dec_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 0              # 0 -> 4*emb_dim
    dropout: float = 0.1
    attention_dropout: float = 0.1
    gelu_activation: bool = True
    share_inout_emb: bool = True
    sinusoidal_embeddings: bool = False
    max_positions: int = N_MAX_POSITIONS
    max_region_num: int = 100
    refine_layers: int = 3
    use_image_dist: bool = False
    attention_setting: str = "v1"
    use_externel_att: bool = False
    image_fusion: bool = False
    asm: bool = False
    asm_cutoffs: Tuple[int, ...] = (8000, 20000)
    asm_div_value: float = 4.0
    eos_index: int = EOS_IDX
    pad_index: int = PAD_IDX
    bos_index: int = BOS_IDX
    mask_index: int = 250001
    n_obj_classes: int = N_OBJ_CLASSES
    img_feat_dim: int = IMG_FEAT_DIM
    img_loc_dim: int = IMG_LOC_DIM
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_pallas_attention: bool = True
    use_fused_dropout: bool = False
    remat: bool = False
    ffn_quant: str = "none"
    head_quant: str = "none"
    seq_axis: Optional[str] = None
    moe_experts: int = 0
    moe_interval: int = 2
    moe_capacity_factor: float = 2.0

    @property
    def ffn_dim(self) -> int:
        return self.hidden_dim if self.hidden_dim else 4 * self.emb_dim

    @property
    def head_dim(self) -> int:
        if self.emb_dim % self.n_heads:
            raise ValueError(f"emb_dim {self.emb_dim} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.emb_dim // self.n_heads


@dataclass
class OptimConfig:
    """Optimizer spec in the reference factory's string form
    (`optim.py:211-270`), parsed by `train.optim.parse_optim_spec`."""

    spec: str = "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005"
    clip_grad_norm: float = 5.0
    accumulate_gradients: int = 1
    weight_decay: float = 0.0


@dataclass
class MeshConfig:
    """Device mesh layout of the JAX package (data, fsdp, seq, tensor,
    expert and pipeline axes).  Kept field for field so a JAX config
    converts; the port runs on one device until the multi-device item."""

    data: int = -1      # -1: all remaining devices
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pp: int = 1
    pp_microbatches: int = 2   # GPipe microbatches when pp > 1
    axis_names: Tuple[str, ...] = ("data", "fsdp", "seq", "tensor", "expert",
                                   "pp")


@dataclass
class DataConfig:
    data_path: str = ""
    # features root override (reference --input_fea_dir); data_path otherwise
    input_fea_dir: str = ""
    seq_per_img: int = 5    # captions per image (eval grids; MILD uses 1)
    vocab_path: str = ""
    lgs: str = "en"
    max_len: int = 64                 # caption truncation (`README.md:183`)
    max_region_num: int = 100
    batch_size: int = 24
    sample_n: int = 4                 # candidate-grid size for ITM (t2i/i2t)
    word_pred: float = 0.15           # MLM masking rate
    sample_alpha: float = 0.0
    word_mask_keep_rand: str = "0.8,0.1,0.1"
    obj_mask_ratio: float = 0.15
    word_shuffle: float = 0.0
    word_dropout: float = 0.0
    word_blank: float = 0.0
    # MCT code-switching (`clag.py`)
    use_mct: bool = False
    cross_lingual_path: str = ""   # MUSE bilingual dictionaries for MCT
    mct_sent_ratio: float = 0.5
    mct_word_ratio: float = 0.3
    seed: int = 12345
    # background reader threads of the input pipeline
    num_workers: int = 1
    # the JAX package's grain pipeline switch (kept for config parity)
    use_grain: bool = True
    # length-grouped batching for parallel/NTG datasets (`--group_by_size`,
    # reference `dataset_utils.py`/NTG iterator sorting)
    group_by_size: bool = True
    # token-count batching (`--tokens_per_batch`/`--max_batch_size`,
    # `dataset_pretrain.py:863-890`), resolved at config time to
    # batch_size = clamp(tokens_per_batch // max_len, 1, max_batch_size)
    tokens_per_batch: int = -1
    max_batch_size: int = 0
    # fixed-shape MLM: max masked positions per sequence (the reference
    # gathers a dynamic number, `xtrainer.py:385-434`)
    max_pred_per_seq: int = 24
    # MCT pretrain: fraction of BN*max_pred slots packed into the vocab-head
    # block (see `mct_pretrain_loss`); 0.25 is safe for real <=20-token
    # captions, 0.5 for worst-case synthetic 64-token ones
    mlm_pack_ratio: float = 0.5
    bptt: int = 128                   # stream dataset block length
    # Missing data for a requested task is a hard error at load time (the
    # reference `check_data_params` asserts file existence up front,
    # `loader.py:25-153`); True restores warn-and-skip for deliberate
    # partial setups
    allow_missing_data: bool = False


@dataclass
class EvalConfig:
    eval_only: bool = False
    beam_size: int = 4
    length_penalty: float = 1.0
    early_stopping: bool = False
    max_gen_len: int = 40
    test_splits: int = 8              # eval-grid chunking (`xevaluator.py:1576`)
    eval_batch_size: int = 64
    # validation-set size caps (`--eval_n`, `xevaluator.py:485,1197`;
    # `--eval_images`, `dataset_finetune.py:961` — -1 = full test grid)
    eval_n: int = 150
    eval_images: int = -1
    # caption metrics to report (`--coco_method`, `xevaluator.py:1010`);
    # deviation: defaults to both since BLEU/CIDEr are in-process here
    # (the reference shells out per metric)
    coco_method: str = "Bleu,CIDEr"
    # artifact dir: retrieval score-matrix .npy + inference.log R@k lines
    # (`--eval_path`, `xevaluator.py:258-259,1616-1619`); empty = no dumps
    eval_path: str = ""
    # "int8": frozen-weight int8 generation evals (`Evaluator`'s int8 copy
    # of the model, its tables captured over the model's shards)
    quant: str = "none"
    # approximate top-k for the beam search's per-step top-2K in the JAX
    # package; the port's top-k is exact either way (`model/generation.py`)
    fast_beam: bool = False


@dataclass
class TrainConfig:
    """Top-level experiment config (replaces the reference `params` namespace)."""

    exp_name: str = "m3p_tpu"
    exp_id: str = ""
    dump_path: str = "./dumped"
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # task step lists (parity DSL, `loader.py:93-104`)
    mlm_steps: str = ""
    clm_steps: str = ""
    cross_rel_steps: str = ""
    cross_mlm_steps: str = ""
    cross_mrm_steps: str = ""
    cross_mrfr_steps: str = ""
    # CLCM gate: concat-caption pairs ride the pretrain i2t batches only
    # when non-empty (`xtrainer.py:2380`)
    cross_clcm_steps: str = ""
    cross_ic_steps: str = ""
    cross_mt_steps: str = ""
    ntg_steps: str = ""
    slide_steps: str = ""
    # generation / text-only objectives (`train_x.py:213-247`):
    #   mass_steps    — MASS segment-masked seq2seq on mono streams
    #   pc_steps      — parallel (translation-pair) classification
    #   tifg_steps    — text->image-feature generation (--cross_gan_steps)
    #   cross_ae_steps— IDA / bart_img region-denoising captioning
    #   ae_steps      — denoising auto-encoding with word noise
    # Under --is_generation the reference also drives bart_mlm/bart_mass
    # from mlm_steps (`train_x.py:457-460`).
    mass_steps: str = ""
    pc_steps: str = ""
    tifg_steps: str = ""
    cross_ae_steps: str = ""
    ae_steps: str = ""
    text_steps: str = ""

    # loss-coefficient schedules (``"0:1,1000:0"`` DSL, `utils.py:249-293`)
    lambda_mlm: str = "1"
    lambda_rel: str = "1"
    lambda_mrm: str = "1"
    lambda_mrfr: str = "1"
    lambda_clcm: str = "1"
    lambda_ic: str = "1"
    lambda_mt: str = "1"
    lambda_t2i: str = "1"
    lambda_i2t: str = "1"
    lambda_clm: str = "1"
    lambda_mass: str = "1"
    lambda_imlm: str = "1"   # bart_mlm coefficient (`train_x.py:459`)
    lambda_ida: str = "1"    # bart_img coefficient (`train_x.py:463`)
    lambda_tifg: str = "1"
    lambda_pc: str = "1"
    lambda_ae: str = "1"

    epoch_size: int = 100000
    max_epoch: int = 100000
    stopping_criterion: str = ""
    validation_metrics: str = ""
    save_periodic: int = 0
    reload_model: str = ""
    reload_checkpoint: str = ""
    is_pretrain: bool = False
    is_understanding: bool = False
    is_generation: bool = False
    is_mt: bool = False
    is_ntg: bool = False
    is_mild: bool = False
    is_slide: bool = False
    is_freelb: bool = False
    ft_all: bool = False    # per-feeder language sharding (`loader.py:187-190`)
    ft_lgs: str = ""        # fine-tune language list (defaults to lgs)
    train_order_path: str = ""  # {google,sbu}_train_order.json dir
    word_mass: float = 0.5  # MASS masked-span fraction (`--word_mass`)
    lg_sampling_factor: float = -1.0  # size^coeff task sampling (`utils.py:296`)
    qp_type: str = "q"      # MILD query / query+passage scoring
    # freeLB adversarial settings (`xtrainer.py:2700-2962`)
    adv_lr: float = 0.001
    adv_steps: int = 3
    norm_type: str = "l2"
    adv_max_norm: float = 0.0
    free_text: bool = True           # PGD delta on token embeddings
    free_img: bool = True            # PGD delta on raw region features
    # AoA image refiner on/off per run (`params.refine_image`, every
    # reference step passes it into jointfwd/crossfwd)
    refine_image: bool = True
    # second AoA refine AFTER the encoder stack on the image stream
    # (`params.refine_encoder` -> `fwd` `transformer.py:869-870`; live in
    # `ic_step` `xtrainer.py:1495` and FreeLB IC `:2741`)
    refine_encoder: bool = False
    # train only one retrieval direction (`--t2i_flag/--i2t_flag`,
    # `xtrainer.py:1871-1877`)
    t2i_flag: bool = True
    i2t_flag: bool = True
    # ITM grid loss = multi*CE + bin*BCE (`xtrainer.py:1938`)
    multi_cls_loss_weight: float = 1.0
    bin_cls_loss_weight: float = 1.0
    # multimodal-MT without the image stream (`xtrainer.py:1561`)
    mt_only_text: bool = False
    # debug fixtures: valid data as train (`loader.py:374-375`), pinned
    # pretrain shard 0 (`dataset_pretrain.py:213-214`)
    debug_train: bool = False
    debug_pretrain: bool = False
    # shard mono streams across data feeders (`loader.py:409-413`)
    split_data: bool = False
    # word-noise the BART source (`bart_mlm_step`, `xtrainer.py:1617`)
    use_noise: float = 0.0
    # MCT source/augmentation languages — restrict the bilingual-lexicon
    # load (`loader.py:666-684`); empty = all pairs found
    src_lgs: str = ""
    ag_lgs: str = ""
    # CLM: exclude the first positions from prediction
    # (`xtrainer.py:712-713`)
    context_size: int = 0
    # pretrain per-epoch model_pretrain_<i> saves (`train_x.py:505-506`)
    save_every_epoch: int = 1
    # multi-process preemption-save decision cadence: the collective
    # "any rank pending?" decision runs every N step boundaries instead of
    # every step; epoch end always saves.  1 restores the per-step decision.
    save_check_every: int = 10

    seed: int = 12345

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @property
    def lang2id(self) -> Dict[str, int]:
        return parse_lgs(self.data.lgs)

    @property
    def id2lang(self) -> Dict[int, str]:
        return {v: k for k, v in self.lang2id.items()}

    @property
    def ft_langs(self) -> List[str]:
        """Fine-tune languages: --ft_lgs when set, else --lgs
        (reference per-language caption loading, `loader.py:275-280`)."""
        if self.ft_lgs:
            return list(parse_lgs(self.ft_lgs).keys())
        return list(self.lang2id.keys())


def scale_up_config(**overrides: Any) -> TrainConfig:
    """The JAX package's pod-slice pre-training preset: a 24-layer encoder
    over the full 100-language XLM-R vocabulary, bf16 with rematerialized
    blocks, an FSDP + TP mesh."""
    model = ModelConfig(
        n_words=250002, mask_index=250001, n_langs=101, emb_dim=768,
        n_layers=24, n_dec_layers=12, n_heads=12, max_region_num=100,
        dtype="bfloat16", remat=True, use_pallas_attention=True,
    )
    mesh = MeshConfig(data=-1, fsdp=4, tensor=2)
    data = DataConfig(lgs="-".join(f"l{i}" for i in range(100)),
                      batch_size=8, sample_n=4)
    cfg = TrainConfig(model=model, mesh=mesh, data=data, is_pretrain=True)
    for k, v in overrides.items():
        cfg = cfg.replace(**{k: v})
    return cfg


def long_context_config(**overrides: Any) -> TrainConfig:
    """Long-sequence preset: 8192 positions (past the reference's hard
    514-position cap, `transformer.py:16`), the sequence dim over a ``seq``
    mesh axis, rematerialized blocks."""
    model = ModelConfig(
        n_words=250002, mask_index=250001, emb_dim=768, n_layers=12,
        n_heads=12, max_positions=8192, max_region_num=100,
        dtype="bfloat16", remat=True, use_pallas_attention=True,
        seq_axis="seq",
    )
    mesh = MeshConfig(data=-1, fsdp=1, seq=4, tensor=1)
    data = DataConfig(max_len=4096, batch_size=8)
    cfg = TrainConfig(model=model, mesh=mesh, data=data)
    for k, v in overrides.items():
        cfg = cfg.replace(**{k: v})
    return cfg


def small_test_config(**overrides: Any) -> TrainConfig:
    """A tiny config for unit tests and CPU dry-runs."""
    model = ModelConfig(
        n_words=512, n_langs=3, emb_dim=64, n_layers=2, n_dec_layers=2,
        n_heads=4, dropout=0.0, attention_dropout=0.0, max_region_num=8,
        refine_layers=1, mask_index=511, dtype="float32",
        use_pallas_attention=False,
    )
    data = DataConfig(max_len=16, max_region_num=8, batch_size=4, sample_n=2,
                      max_pred_per_seq=4)
    cfg = TrainConfig(model=model, data=data)
    for k, v in overrides.items():
        if hasattr(cfg, k):
            cfg = cfg.replace(**{k: v})
        elif hasattr(cfg.model, k):
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, **{k: v}))
        elif hasattr(cfg.data, k):
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, **{k: v}))
        else:
            raise AttributeError(k)
    return cfg
