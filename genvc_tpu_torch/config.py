"""Typed configuration tree for genvc_tpu_torch.

The port's own copy of ``genvc_tpu/config.py`` (the port imports nothing from
the JAX package). Field names deliberately mirror the reference config system
(coqpit dataclasses, reference configs/*.py) so that torch checkpoint bundles —
which embed the config as a plain dict — round-trip into this tree via
:func:`from_dict` (reference: configs/genVC_train_configs.py:15-90,
inference/model_init.py:11-12).

The tree is plain Python dataclasses (no coqpit dependency): serializable with
``to_dict``/``from_dict``, unknown keys ignored on load so that reference
checkpoints with extra coqui-trainer fields still parse.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Union


def _build(cls, data):
    """Recursively build a dataclass from a dict, ignoring unknown keys."""
    if data is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        f = fields.get(key)
        if f is None:
            continue
        ftype = f.type if not isinstance(f.type, str) else None
        target = _DATACLASS_FIELDS.get((cls.__name__, key))
        if target is not None and isinstance(value, dict):
            kwargs[key] = _build(target, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


class _ConfigBase:
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict):
        return _build(cls, data)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str):
        return cls.from_dict(json.loads(text))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


def _check_range(name, value, min_val=None, max_val=None, allow_none=False):
    """One bounded-field check (reference: coqpit ``check_argument`` semantics as
    used by configs/base_configs.py:159-191 ``check_values``)."""
    if value is None:
        if allow_none:
            return
        raise ValueError(f"audio config field '{name}' must not be None")
    if min_val is not None and value < min_val:
        raise ValueError(
            f"audio config field '{name}'={value!r} is below the allowed minimum {min_val}"
        )
    if max_val is not None and value > max_val:
        raise ValueError(
            f"audio config field '{name}'={value!r} is above the allowed maximum {max_val}"
        )


@dataclass
class AudioConfig(_ConfigBase):
    """STFT/mel/sample-rate parameters (reference: configs/base_configs.py:115-157)."""

    fft_size: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    stft_pad_mode: str = "reflect"
    num_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    dvae_sample_rate: int = 24000
    sample_rate: int = 24000
    output_sample_rate: int = 24000
    content_sample_rate: int = 16000

    def __post_init__(self):
        # coqpit runs check_values at construction time, so every reference
        # config path (including checkpoint round-trip) is validated on build.
        self.check_values()

    def check_values(self):
        """Bounds validation mirroring reference BaseAudioConfig.check_values
        (configs/base_configs.py:159-191) for the fields this tree carries.
        Fields the rebuild dropped (preemphasis, griffin-lim power, signal-norm
        knobs) are defaulted constants here and need no runtime check."""
        _check_range("num_mels", self.num_mels, 10, 2056)
        _check_range("fft_size", self.fft_size, 128, 4058)
        _check_range("sample_rate", self.sample_rate, 512, 100000)
        _check_range("dvae_sample_rate", self.dvae_sample_rate, 512, 100000)
        _check_range("output_sample_rate", self.output_sample_rate, 512, 100000)
        _check_range("content_sample_rate", self.content_sample_rate, 512, 100000)
        # reference validates frame_length_ms/frame_shift_ms with win_length/
        # hop_length as the "alternative" fields; we carry the sample-domain pair.
        _check_range("win_length", self.win_length, 1, self.fft_size)
        _check_range("hop_length", self.hop_length, 1, self.win_length)
        _check_range("mel_fmin", self.mel_fmin, 0.0, 1000.0)
        _check_range("mel_fmax", self.mel_fmax, 500.0, None, allow_none=True)
        if self.mel_fmax is not None and self.mel_fmax > self.sample_rate / 2:
            raise ValueError(
                f"audio config field 'mel_fmax'={self.mel_fmax!r} exceeds the "
                f"Nyquist frequency {self.sample_rate / 2} of sample_rate={self.sample_rate}"
            )
        if self.stft_pad_mode not in ("reflect", "constant"):
            raise ValueError(
                f"audio config field 'stft_pad_mode'={self.stft_pad_mode!r} "
                "must be 'reflect' or 'constant'"
            )


@dataclass
class VAEConfig(_ConfigBase):
    """Discrete VAE stage config (reference: configs/vae_config.py:5-44)."""

    lr: float = 1e-4
    opt_betas: List[float] = field(default_factory=lambda: [0.9, 0.997])
    audio: AudioConfig = field(default_factory=AudioConfig)
    feat_type: str = "Mel-spectrogram"
    mel_norm_file: Optional[str] = None
    contentvec_model_path: Optional[str] = None
    warmup_steps: int = 1000

    batch_size: int = 8
    eval_batch_size: int = 8
    num_loader_workers: int = 4
    max_wav_len: int = 16384
    train_metafile: str = "data/train.txt"
    test_metafile: str = "data/test.txt"

    epochs: int = 1000
    grad_clip_norm: float = 0.5
    log_interval: int = 100
    save_interval: int = 1000
    eval_interval: int = 5000
    save_dir: str = "exp/dvae"
    output_path: str = "exp/dvae"
    use_wandb: bool = False
    vae_checkpoint: Optional[str] = None
    wandb_project: str = "vae"
    wandb_run_name: str = "vae"
    save_n_checkpoints: int = 2
    save_step: int = 5000

    # model
    num_channels: int = 80
    num_tokens: int = 256
    codebook_dim: int = 512
    hidden_dim: int = 64
    num_resnet_blocks: int = 1
    kernel_size: int = 3
    num_layers: int = 2


@dataclass
class VocoderConfig(_ConfigBase):
    """HiFi-GAN generator + discriminator config (reference: configs/vocoder_configs.py:5-38)."""

    input_feat_dim: int = 1024
    sample_rate: int = 24000
    fft_size: int = 1024
    num_mels: int = 100
    mel_fmin: float = 0
    mel_fmax: float = 12000
    win_length: int = 1024
    hop_length: int = 256
    upsample_initial_channel: int = 256
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 5, 7])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 2], [2, 6], [3, 12]]
    )
    upsample_rates: List[int] = field(default_factory=lambda: [8, 8, 4])
    upsample_kernal_sizes: List[int] = field(default_factory=lambda: [16, 16, 8])
    resblock_type: str = "2"
    # MPD
    mpd_reshapes: List[int] = field(default_factory=lambda: [2, 3, 5, 7, 11])
    mpd_discriminator_channel_mult_factor: int = 1
    mpd_use_spectral_norm: bool = False
    # MS-STFT
    msstftd_filters: int = 32
    # MS-SB-CQT
    mssbcqtd_filters: int = 32
    mssbcqtd_max_filters: int = 1024
    mssbcqtd_filters_scale: int = 1
    mssbcqtd_dilations: List[int] = field(default_factory=lambda: [1, 2, 4])
    mssbcqtd_in_channels: int = 1
    mssbcqtd_out_channels: int = 1
    mssbcqtd_hop_lengths: List[int] = field(default_factory=lambda: [512, 256, 256])
    mssbcqtd_n_octavess: List[int] = field(default_factory=lambda: [9, 9, 9])
    mssbcqtd_bins_per_octave: List[int] = field(default_factory=lambda: [24, 36, 48])


@dataclass
class GPTModelArgs(_ConfigBase):
    """GPT / model-structure arguments (reference: configs/genVC_configs.py:97-157,
    configs/genVC_train_configs.py:15-30)."""

    gpt_batch_size: int = 1
    kv_cache: bool = True

    gpt_max_audio_tokens: int = 605
    gpt_max_text_tokens: int = 402
    gpt_max_prompt_tokens: int = 70
    gpt_layers: int = 30
    gpt_n_model_channels: int = 1024
    gpt_n_heads: int = 16
    gpt_number_text_tokens: Optional[int] = None
    gpt_start_text_token: Optional[int] = None
    gpt_stop_text_token: Optional[int] = None
    gpt_num_audio_tokens: int = 1026
    gpt_start_audio_token: int = 1024
    gpt_stop_audio_token: int = 1025
    gpt_code_stride_len: int = 1024

    min_conditioning_length: int = 72000
    max_conditioning_length: int = 144000
    gpt_loss_text_ce_weight: float = 0.01
    gpt_loss_mel_ce_weight: float = 1.0
    debug_loading_failures: bool = False
    min_text_length: int = 100
    max_text_length: int = 300
    mel_norm_file: Optional[str] = None
    gpt_content_dim: int = 256
    dvae_checkpoint: str = ""
    content_dvae_checkpoint: str = ""
    gpt_checkpoint: Optional[str] = ""
    hifigan_checkpoint: Optional[str] = ""
    vocoder: str = ""
    gpt_use_masking_gt_prompt_approach: bool = False
    gpt_fix_condition_embeddings: bool = False


@dataclass
class GenVCConfig(_ConfigBase):
    """Top-level training / inference config
    (reference: configs/genVC_train_configs.py:32-90 ``GPTTrainerConfig``)."""

    lr: Union[float, List[float]] = 5e-06
    training_seed: int = 1
    optimizer_wd_only_on_weights: bool = True
    model_args: GPTModelArgs = field(default_factory=GPTModelArgs)
    audio: AudioConfig = field(default_factory=AudioConfig)
    acoustic_dvae_config: VAEConfig = field(default_factory=VAEConfig)
    content_dvae_config: VAEConfig = field(default_factory=VAEConfig)
    vocoder_config: VocoderConfig = field(default_factory=VocoderConfig)
    epochs: int = 200
    weight_decay: float = 0.0
    warmup_steps: int = 1000
    lr_scheduler: str = "cosine"
    lr_scheduler_params: dict = field(default_factory=dict)
    lr_decay: float = 0.98
    max_grad_norm: float = 1.0
    seed: int = 1994
    is_inference: bool = False
    optimizer: str = "AdamW"
    optimizer_params: Optional[dict] = None

    # logging / saving
    log_interval: int = 100
    save_interval: int = 1000
    eval_interval: int = 1000
    save_dir: str = "exp/gpt"
    output_path: str = "exp/gpt"
    resume_checkpoint: Optional[str] = None
    save_n_checkpoints: int = 2
    save_step: int = 5000
    print_step: int = 50

    use_wandb: bool = False
    wandb_project: str = "train_gpt_vc"
    wandb_run_name: str = "libritts"

    # dataset
    batch_size: int = 8
    eval_batch_size: int = 4
    num_loader_workers: int = 0
    train_metafile: str = "metafiles/libritts_train.txt"
    test_metafile: str = "metafiles/libritts_test.txt"
    text_frame_rate: float = 0.02

    # inference sampling (reference: genVC_train_configs.py:75-81)
    temperature: float = 0.85
    length_penalty: float = 1.0
    repetition_penalty: float = 2.0
    top_k: int = 15
    top_p: float = 0.85
    num_gpt_outputs: int = 1

    # cloning (reference: genVC_train_configs.py:83-90)
    gpt_cond_len: int = 12
    gpt_cond_chunk_len: int = 4
    max_ref_len: int = 10
    sound_norm_refs: bool = False
    acoustic_dvae_checkpoint: Optional[str] = ""
    content_dvae_checkpoint: Optional[str] = ""
    contentvec_model_path: str = "pretrained_models/contentVec.pth"


@dataclass(frozen=True)
class MLAMoEConfig(_ConfigBase):
    """The DeepSeek-V3 decoder backbone (latent attention, a mixture of
    experts; ``models/mla_moe.py``) in place of GenVC's GPT-2 blocks, its
    fields named as in a DeepSeek-V3 ``config.json`` (defaults:
    Moonlight-16B-A3B's). GenVC's GPT-2 blocks are the default: a pipeline
    is handed one of these (``build_pipeline(..., backbone=)``) to run this
    one. ``n_group`` = ``topk_group`` = 1 (a plain top-k) is the only
    grouping built."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# Mapping used by _build to know which nested dict fields become dataclasses.
_DATACLASS_FIELDS = {
    ("VAEConfig", "audio"): AudioConfig,
    ("GenVCConfig", "audio"): AudioConfig,
    ("GenVCConfig", "model_args"): GPTModelArgs,
    ("GenVCConfig", "acoustic_dvae_config"): VAEConfig,
    ("GenVCConfig", "content_dvae_config"): VAEConfig,
    ("GenVCConfig", "vocoder_config"): VocoderConfig,
}


def gpt_max_gen_mel_tokens(args: GPTModelArgs) -> int:
    """Max new audio tokens per generation (reference: layers/gpt.py:131)."""
    max_conditioning_inputs = 1
    return args.gpt_max_audio_tokens - max_conditioning_inputs - 2


def gpt_total_mel_positions(args: GPTModelArgs) -> int:
    """Size of the learned mel positional table (reference: layers/gpt.py:132)."""
    return args.gpt_max_audio_tokens + 2 + 1


def gpt_total_text_positions(args: GPTModelArgs) -> int:
    """Size of the learned text positional table (reference: layers/gpt.py:133)."""
    return args.gpt_max_text_tokens + 2
