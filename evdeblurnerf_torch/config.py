"""Flags of the port: the flag table, the config-file parser and the
port's own defaults.

Counterpart of ``evdeblurnerf_tpu/config.py`` (ref: options.py:13-388): the
same flag names and types and the reference's flat ``key = value``
config-txt format, so the experiment configs under ``configs/`` and old
command lines parse unchanged:

    python run_nerf_torch.py --config configs/.../experiment.txt [--flag v]

Supported config-file syntax (superset of what the reference configs use):
  * ``key = value`` / ``key value`` / bare ``key`` (boolean true)
  * quoted strings, ``[a, b, c]`` lists, inline ``#`` comments
  * CLI flags override config-file values; later duplicates in the file win.

What differs from the JAX package's table:

  * :data:`PORT_DEFAULTS`: f32 tables and reference-exact sampling
    (``triplane_bf16``, ``triplane_line_matmul`` and ``fine_cull_capacity``
    off), and ``grad_accum`` 1, since the paper step at ``grad_accum 1``
    fits one H100's 80 GB with room to spare (PERF.md). A value set on the
    command line or in the config file wins.
  * ``--device`` (``cuda`` by default): the entry points run on the card
    unless the caller asks for ``cpu``.
  * Flags that steer TPU mechanisms (``compilation_cache_dir``,
    ``matmul_precision``, ``tp_model_parallel``, ``multihost``, ``remat``)
    stay accepted; :func:`check_supported` raises ``NotImplementedError``
    for a value that asks for something the port does not do yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class Flag:
    name: str
    type: Any = str
    default: Any = None
    nargs: Optional[int] = None       # fixed-arity list ("+"-style uses -1)
    choices: Optional[Sequence] = None
    is_list: bool = False             # accepts [a,b,...] syntax
    help: str = ""


def _flag(name, type=str, default=None, nargs=None, choices=None, help=""):
    return Flag(name=name, type=type, default=default, nargs=nargs,
                choices=choices, is_list=nargs is not None, help=help)


def _bool(name, default=False, help=""):
    return Flag(name=name, type=bool, default=default, help=help)


# defaults that differ from the JAX package's (module docstring)
PORT_DEFAULTS = {
    "triplane_bf16": False,
    "triplane_line_matmul": False,
    "fine_cull_capacity": 0.0,
    "grad_accum": 1,
}

# The full flag surface of ref: options.py (same names, types, defaults).
FLAG_SPEC = [
    _flag("config", str, None),
    _flag("expname", str, None),
    _flag("basedir", str, "./logs/"),
    _flag("datadir", str, None),
    _flag("datadownsample", float, -1.0),
    # extension of the JAX package (not an upstream flag): image
    # minification filter. "area" = cv2 INTER_AREA (fast default);
    # "lanczos" = PIL LANCZOS, approximating the reference's ImageMagick
    # mogrify shell-out (ref: utils/data.py:64-116)
    _flag("minify_filter", str, "area", choices=("area", "lanczos")),
    _flag("tbdir", str, None),
    _bool("no_wandb"),
    _bool("use_tensorboard"),
    _flag("num_gpu", int, 1),           # kept for config compat
    # the JAX package's parallel paths; accepted, and check_supported()
    # raises for tp_model_parallel > 1 and multihost (ROADMAP item 22)
    _flag("tp_model_parallel", int, 1),
    _bool("multihost"),
    _flag("torch_hub_dir", str, ""),
    _bool("no_log_grads_norm"),
    _flag("clip_grads_norm", float, None),

    # Training
    _flag("seed", int, 0),
    _flag("mode", str, "c2f", choices=["c2f", "nerf"]),
    _flag("ray_sampling_mode", str, "random", choices=["random", "images"]),
    _flag("ray_sampling_images_num", int, 32),
    _flag("netdepth", int, 8),
    _flag("netwidth", int, 256),
    _flag("netdepth_fine", int, 8),
    _flag("netwidth_fine", int, 256),
    _flag("N_rand", int, 32 * 32 * 4),
    _flag("lrate", float, 5e-4),
    _flag("lrate_warmup_factor", float, 0.1),
    _flag("lrate_warmup_iters", float, -1),
    _flag("lrate_decay", int, 250),
    _flag("colornet_weightdecay", float, None),
    _flag("chunk", int, 1024 * 32),
    _flag("netchunk", int, 1024 * 64),
    _bool("no_reload"),
    _flag("ft_path", str, None),
    _flag("N_iters", int, 50000),
    _flag("N_samples", int, 64),
    _flag("N_importance", int, 0),
    _flag("perturb", float, 1.0),
    _bool("use_viewdirs"),
    _flag("multires", int, 10),
    _flag("multires_views", int, 4),
    _flag("raw_noise_std", float, 0.0),
    _flag("rgb_activate", str, "sigmoid"),
    _bool("rgb_add_bias"),
    _flag("sigma_activate", str, "relu"),
    _flag("dataset_type", str, "llff", choices=["llff"]),
    _bool("white_bkgd"),
    _bool("half_res"),
    _flag("factor", int, None),
    _bool("no_ndc"),
    _bool("lindisp"),
    _bool("spherify"),
    _bool("pose_transform_allknown"),
    _flag("bd_factor", float, 0.75),
    _flag("llffhold", int, 8),
    _bool("llffhold_end"),

    # CRR/FVR (PDRF coarse-to-fine voxel fields)
    _flag("coarse_num_layers", int, 2),
    _flag("coarse_num_layers_color", int, 3),
    _flag("coarse_hidden_dim", int, 64),
    _flag("coarse_hidden_dim_color", int, 64),
    _flag("coarse_app_dim", int, 32),
    _flag("coarse_app_n_comp", int, None, nargs=-1),
    _flag("coarse_n_voxels", int, 16777248),
    _flag("coarse_app_actfn", str, "none"),
    _flag("fine_num_layers", int, 2),
    _flag("fine_num_layers_color", int, 3),
    _flag("fine_hidden_dim", int, 256),
    _flag("fine_hidden_dim_color", int, 256),
    _flag("fine_app_dim", int, 32),
    _flag("fine_geo_feat_dim", int, 128),
    _flag("fine_app_n_comp", int, None, nargs=-1),
    _flag("fine_app_actfn", str, "none"),
    _flag("fine_n_voxels", int, 134217984),

    # Events
    _flag("use_pts0_prior", str, None, choices=["edi"]),
    _flag("pts0_edi_steps", int, 9),
    _flag("pts0_target_weight", float, 0.1),
    _flag("pts0_target_weight_end", float, 1.0),
    _flag("pts0_target_weight_steps", int, None),
    _flag("pts0_target_weight_scheduler", str, "constant",
          choices=["constant", "linear", "cosine"]),
    _flag("pts0_target_start_iter", int, -1),
    _flag("pts0_target_end_iter", int, 9999999),
    _bool("use_events"),
    _flag("tone_mapping_events_type", str, "none", choices=["gamma", "learn", "none"]),
    _flag("tone_mapping_events_add_bii", str, "none",
          choices=["none", "pos-neg", "color-pos-neg"]),
    _flag("events_tms_unit", str, "ns", choices=["ns", "us"]),
    _flag("events_tms_files_unit", str, "us", choices=["ns", "us"]),
    _flag("events_N_rand", int, 32 * 32 * 4 // 2),
    _flag("events_threshold", float, 0.2),
    _flag("events_threshold_pos", float, None),
    _flag("events_threshold_neg", float, None),
    _bool("add_event_egm"),
    _bool("event_egm_use_colorevents"),
    _flag("event_egm_use_color_weights", float, None, nargs=3),
    _flag("event_egm_color_weights_start_iter", int, -1),
    _bool("event_egm_use_awp"),
    _bool("event_egm_awp_use_coarse_to_fine_opt"),
    _flag("add_event_egm_stages", str, ["stage0"], nargs=-1),
    _flag("add_event_egm_startiter", int, None),
    _flag("event_accumulate_step_range", int, [0, 0], nargs=2),
    _flag("event_accumulate_step_range_end", int, [0, 0], nargs=2),
    _flag("event_accumulate_step_scheduler", str, "constant",
          choices=["constant", "linear", "cosine"]),
    _flag("event_accumulate_step_end", int, 0),
    _flag("event_egm_weight", float, 1.0),
    _flag("event_egm_weight_end", float, 1.0),
    _flag("event_egm_weight_steps", int, None),
    _flag("event_egm_weight_scheduler", str, "constant",
          choices=["constant", "linear", "cosine"]),

    # Blur-kernel optimisation
    _flag("blur_loss_after", int, -1),
    _flag("kernel_type", str, "kernel"),
    _bool("kernel_isglobal"),
    _flag("kernel_start_iter", int, 0),
    _flag("kernel_start_warmup_mode", str, "step", choices=["step", "cosine", "linear"]),
    _flag("kernel_start_warmup_iters", int, 1),
    _flag("kernel_ptnum", int, 5),
    _flag("kernel_random_hwindow", float, 0.25),
    _flag("kernel_img_embed_type", str, "param", choices=["param", "param_mlp"]),
    _flag("kernel_img_embed_init", str, "zero", choices=["zero", "normal", "linspace"]),
    _flag("kernel_img_embed", int, 32),
    _flag("kernel_img_mlp_embed", int, 32),
    _flag("kernel_img_mlp_depth", int, 4),
    _flag("kernel_img_mlp_skips", int, 4),
    _flag("kernel_feat_cnl", int, 15),
    _flag("kernel_rand_dim", int, 2),
    _flag("kernel_rand_embed", int, 3),
    _flag("kernel_random_mode", str, "input", choices=["input", "output"]),
    _flag("kernel_spatial_embed", int, 0),
    _flag("kernel_depth_embed", int, 0),
    _flag("kernel_hwindow", int, 10),
    _flag("kernel_pattern_init_radius", float, 0.1),
    _flag("kernel_num_hidden", int, 3),
    _flag("kernel_num_wide", int, 64),
    _bool("kernel_shortcut"),
    _flag("align_start_iter", int, 0),
    _flag("align_end_iter", float, 1e10),
    _flag("kernel_align_weight", float, 0.0),
    _flag("kernel_tv_loss_weight", float, 1.0),
    _bool("kernel_spatialvariant_trans"),
    _bool("kernel_global_trans"),
    _flag("kernel_rbk_extra_feat_ch", int, 15),
    _bool("kernel_rbk_use_viewdirs"),
    _flag("kernel_rbk_enc_brc_skips", int, 4),
    _flag("kernel_rbk_se_r_depth", int, 1),
    _flag("kernel_rbk_se_r_width", int, 32),
    _flag("kernel_rbk_se_r_output_ch", int, 3),
    _flag("kernel_rbk_se_v_depth", int, 1),
    _flag("kernel_rbk_se_v_width", int, 32),
    _flag("kernel_rbk_se_v_output_ch", int, 3),
    _flag("kernel_rbk_ccw_depth", int, 1),
    _flag("kernel_rbk_ccw_width", int, 32),
    _flag("kernel_rbk_se_rv_window", float, 0.2),
    _bool("kernel_rbk_use_origin"),
    _flag("kernel_rbk_feature_extractor_type", str, None,
          choices=["resnet18", "resnet34"]),
    _bool("kernel_rbk_feature_extractor_pretrained"),
    _bool("kernel_rbk_feature_extractor_process_views_separately"),
    _bool("kernel_use_awp"),
    _bool("kernel_awp_use_coarse_to_fine_opt"),
    _flag("kernel_awp_fine_loss_start_ratio", float, 0.1),
    _flag("kernel_awp_fine_loss_end_ratio", float, 0.9),
    _flag("kernel_awp_sam_emb_depth", int, 4),
    _flag("kernel_awp_sam_emb_width", int, 32),
    _flag("kernel_awp_dir_freq", int, 2),
    _flag("kernel_awp_mot_emb_depth", int, 1),
    _flag("kernel_awp_mot_emb_width", int, 32),
    _flag("kernel_awp_rgb_freq", int, 2),
    _flag("kernel_awp_depth_freq", int, 2),
    _flag("kernel_awp_ray_dir_freq", int, 2),

    # Tonemapping
    _flag("tone_mapping_type", str, "none", choices=["none", "gamma"]),
    _flag("tone_mapping_start_learn_iter", int, 0),
    _bool("tone_mapping_learn_init_identity"),
    _flag("tone_mapping_gamma", float, 2.2),

    # Render
    _bool("render_only"),
    _bool("render_test"),
    _bool("render_multipoints"),
    _flag("render_rmnearplane", int, 0),
    _flag("render_focuspoint_scale", float, 1.0),
    _flag("render_radius_scale", float, 1.0),
    _flag("render_factor", int, 0),
    _bool("render_epi"),

    # Extensions of the JAX package (no reference counterpart). The port
    # accepts them all; check_supported() names what it does not do yet
    _flag("fine_cull_capacity", float, PORT_DEFAULTS["fine_cull_capacity"],
          help="transmittance-culled fine sampling (0 = off, reference "
               "behavior): per ray, the fine pass evaluates only the "
               "capacity*(N_samples+N_importance) samples with the largest "
               "coarse transmittance above --fine_cull_eps. Not ported yet: "
               "a value above 0 raises"),
    _flag("fine_cull_eps", float, 1e-3,
          help="coarse-transmittance floor below which a fine-pass sample "
               "is cullable (bounds the per-ray color error)"),
    _bool("fine_cull_eval",
          help="apply the transmittance cull (same capacity/eps) to "
               "eval/test renders too"),
    _flag("fine_cull_start_iter", int, 1000,
          help="enable fine culling only from this iteration"),
    _flag("coarse_cull_capacity", float, 0.0,
          help="occupancy-grid culled coarse sampling (0 = off, reference "
               "behavior). Not ported yet: a value above 0 raises"),
    _flag("coarse_cull_start_iter", int, 1000,
          help="enable coarse culling only from this iteration"),
    _flag("occ_grid_size", int, 64,
          help="occupancy grid resolution G (G^3 cells over the scene "
               "aabb)"),
    _flag("occ_eps", float, 1e-4,
          help="per-sample alpha threshold below which a voxel counts as "
               "empty at the grid refresh"),
    _flag("occ_dilate", int, 1,
          help="rounds of 3^3 max-pool dilation applied to the occupancy "
               "grid at refresh"),
    _flag("occ_probe_stride", int, 8,
          help="keep every k-th stratified lane regardless of occupancy"),
    _flag("occ_refresh_every", int, 256,
          help="refresh the occupancy grid every N steps"),
    _flag("occ_gate_margin", float, 1.0,
          help="budget-sufficiency gate for the coarse cull"),
    _bool("remat", default=False,
          help="accepted for old command lines; the port does not "
               "rematerialize (use --grad_accum to cut the activation "
               "peak)"),
    _flag("grad_accum", int, PORT_DEFAULTS["grad_accum"],
          help="microbatched gradient accumulation inside the step; cuts "
               "the activation peak 1/N with no recompute"),
    _bool("triplane_bf16", default=PORT_DEFAULTS["triplane_bf16"],
          help="bf16 table rows in the forward pass. Not ported yet: True "
               "raises"),
    _bool("triplane_line_matmul",
          default=PORT_DEFAULTS["triplane_line_matmul"],
          help="accepted for old command lines and ignored: the port's "
               "sampler kernels read the line tables themselves"),
    _flag("compilation_cache_dir", str, "auto",
          help="accepted for old command lines and ignored: the port runs "
               "eagerly and has no compiled-program cache"),
    _flag("matmul_precision", str, "default",
          choices=["default", "high", "highest"],
          help="accepted for old command lines and ignored: the port's "
               "float32 products always run in full float32 (TF32 off)"),
    _flag("profile_start_step", int, -1,
          help="capture a trace starting at this step. Not ported yet: a "
               "value >= 0 raises"),
    _flag("profile_num_steps", int, 5),
    _flag("profile_dir", str, None,
          help="trace output dir (default <expdir>/profile)"),
    _flag("device", str, "cuda",
          help="where the model runs: 'cuda' (the default; fails where "
               "there is no card), 'cuda:N' or 'cpu'"),

    # Logging / saving
    _flag("i_print", int, 200),
    _flag("i_tensorboard", int, 200),
    _flag("i_weights", int, 5000),
    _flag("i_testset", int, 5000),
    _flag("i_video", int, 25000),
]

_SPEC_BY_NAME = {f.name: f for f in FLAG_SPEC}

_TRUE_STRINGS = {"true", "yes", "1", "on"}
_FALSE_STRINGS = {"false", "no", "0", "off"}


class Args:
    """Attribute-style container over parsed flag values."""

    def __init__(self, values: dict):
        self.__dict__.update(values)

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self.__dict__.items()))
        return f"Args({body})"

    def as_dict(self):
        return dict(self.__dict__)


def _strip_inline_comment(line: str) -> str:
    # Inline comments appear in reference configs
    # (ref: configs/evdeblurnerf_cdavis/...color.txt:84 "kernel_rand_embed = 2  # ...")
    out, in_quote = [], None
    for ch in line:
        if in_quote:
            out.append(ch)
            if ch == in_quote:
                in_quote = None
        elif ch in "'\"":
            in_quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def _unquote(tok: str) -> str:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    return tok


def _split_list(raw: str):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        raw = raw[1:-1]
    parts = [p for chunk in raw.split(",") for p in chunk.split()]
    return [_unquote(p) for p in parts if p]


def _coerce_scalar(flag: Flag, raw):
    if raw is None:
        return None
    if isinstance(raw, str):
        raw = _unquote(raw)
        # "none" means python-None only for flags that default to None
        # (e.g. ft_path, use_pts0_prior); for flags with a string default it
        # is a real value (kernel_type=none, tone_mapping_type=none, ...)
        if raw.lower() in ("none", "null") and (
                flag.type is not str or flag.default is None):
            return None
    if flag.type is bool:
        if isinstance(raw, bool):
            return raw
        low = str(raw).strip().lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(f"flag --{flag.name}: cannot parse boolean from {raw!r}")
    if flag.type is int:
        return int(float(raw)) if isinstance(raw, str) and "." in raw else int(raw)
    if flag.type is float:
        return float(raw)
    value = str(raw)
    if flag.choices is not None and value not in flag.choices:
        raise ValueError(f"flag --{flag.name}: {value!r} not in {list(flag.choices)}")
    return value


def _coerce(flag: Flag, raw):
    if flag.is_list:
        if raw is None:
            return None
        items = _split_list(raw) if isinstance(raw, str) else list(raw)
        values = [_coerce_scalar(dataclasses.replace(flag, nargs=None), x) for x in items]
        if flag.nargs not in (None, -1) and len(values) != flag.nargs:
            raise ValueError(
                f"flag --{flag.name}: expected {flag.nargs} values, got {values}")
        return values
    return _coerce_scalar(flag, raw)


def parse_config_file(path: str) -> dict:
    """Parse a flat ``key = value`` config txt (ref config file format)."""
    raw_values = {}
    with open(path, "r") as handle:
        for line in handle:
            line = _strip_inline_comment(line).strip()
            if not line:
                continue
            if "=" in line:
                key, _, value = line.partition("=")
                key, value = key.strip(), value.strip()
            else:
                parts = line.split(None, 1)
                key = parts[0]
                value = parts[1].strip() if len(parts) > 1 else None
            if key not in _SPEC_BY_NAME:
                raise ValueError(f"{path}: unknown flag {key!r}")
            flag = _SPEC_BY_NAME[key]
            if value is None:
                if flag.type is not bool:
                    raise ValueError(f"{path}: flag {key!r} requires a value")
                raw_values[key] = True
            else:
                raw_values[key] = value
    return raw_values


def _parse_cli(argv: Sequence[str]) -> dict:
    raw_values = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected positional argument {tok!r}")
        tok = tok[2:]
        if "=" in tok:
            key, _, value = tok.partition("=")
            raw_values[key.strip()] = value
            i += 1
            continue
        key = tok
        if key not in _SPEC_BY_NAME:
            raise ValueError(f"unknown flag --{key}")
        flag = _SPEC_BY_NAME[key]
        vals = []
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            vals.append(argv[j])
            j += 1
        if flag.type is bool and not vals:
            raw_values[key] = True
        elif flag.is_list:
            raw_values[key] = " ".join(vals) if vals else None
        else:
            if not vals:
                raise ValueError(f"flag --{key} requires a value")
            raw_values[key] = vals[0]
        i = j if vals else i + 1
    return raw_values


def format_help() -> str:
    """Flag reference for --help: name, type, default, and help text."""
    lines = ["usage: evdn-train-torch [--config FILE.txt] [--flag value ...]",
             "",
             "Config-file values act as defaults; explicit CLI flags "
             "override them (reference-compatible format).",
             ""]
    for f in FLAG_SPEC:
        t = ("bool" if f.type is bool
             else f.type.__name__ + ("[]" if f.is_list else ""))
        head = f"  --{f.name} ({t}, default {f.default!r})"
        if f.choices:
            head += f" choices={list(f.choices)}"
        lines.append(head)
        if f.help:
            import textwrap

            lines.extend(textwrap.wrap(f.help, width=72,
                                       initial_indent="      ",
                                       subsequent_indent="      "))
    return "\n".join(lines)


def parse_args(argv: Optional[Sequence[str]] = None) -> Args:
    """Parse CLI args layered over an optional ``--config`` file.

    Mirrors configargparse semantics (ref: options.py:14-16): config-file
    values act as defaults, explicit CLI flags override them.
    """
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(format_help())
        raise SystemExit(0)
    cli_raw = _parse_cli(argv)

    values = {f.name: f.default for f in FLAG_SPEC}
    if cli_raw.get("config"):
        file_raw = parse_config_file(_unquote(str(cli_raw["config"])))
        for key, raw in file_raw.items():
            values[key] = _coerce(_SPEC_BY_NAME[key], raw)
    for key, raw in cli_raw.items():
        values[key] = _coerce(_SPEC_BY_NAME[key], raw)
    if cli_raw.get("config"):
        values["config"] = _unquote(str(cli_raw["config"]))
    _validate(values)
    return Args(values)


def _validate(values: dict):
    """Cross-flag constraints that would otherwise fail deep in tracing."""
    ga = values.get("grad_accum") or 1
    for flag in ("N_rand", "events_N_rand"):
        n = values.get(flag)
        if n and n % ga != 0:
            raise ValueError(
                f"--{flag}={n} must be divisible by --grad_accum={ga} "
                "(the step cuts the ray batch into grad_accum equal "
                "microbatches; pick a divisible batch or "
                "--grad_accum 1)")
    # a typo'd stage name would otherwise silently zero the event loss
    # (the train step gates on exact membership, like ref run_nerf.py:561-565)
    bad = [s for s in (values.get("add_event_egm_stages") or ())
           if s not in ("stage0", "stage1")]
    if bad:
        raise ValueError(
            f"--add_event_egm_stages got {bad}; valid stages are "
            "'stage0' (coarse render) and 'stage1' (fine render)")


def default_args(**overrides) -> Args:
    """Programmatic Args with defaults, for tests and library use."""
    values = {f.name: f.default for f in FLAG_SPEC}
    for key, val in overrides.items():
        if key not in _SPEC_BY_NAME:
            raise ValueError(f"unknown flag {key!r}")
        flag = _SPEC_BY_NAME[key]
        values[key] = _coerce(flag, val) if isinstance(val, str) else val
    _validate(values)
    return Args(values)


def check_supported(args: Args) -> None:
    """Raise ``NotImplementedError`` for a flag value that asks for
    something the port does not do yet, naming its ROADMAP queue-1 item.
    Flags that only steer TPU mechanisms (``compilation_cache_dir``,
    ``matmul_precision``, ``remat``, ``triplane_line_matmul``) are accepted
    and ignored."""
    def asks(name, default=0):
        return getattr(args, name, default) or default

    todo = []
    if asks("fine_cull_capacity", 0.0) > 0:
        todo.append(("--fine_cull_capacity > 0 (the transmittance fine "
                     "cull)", 17))
    if asks("coarse_cull_capacity", 0.0) > 0:
        todo.append(("--coarse_cull_capacity > 0 (the occupancy coarse cull "
                     "and its gate)", 20))
    if asks("tp_model_parallel", 1) > 1:
        todo.append(("--tp_model_parallel > 1", 22))
    if getattr(args, "multihost", False):
        todo.append(("--multihost", 22))
    if getattr(args, "triplane_bf16", False):
        todo.append(("--triplane_bf16 (bf16 tables)", 24))
    if getattr(args, "mode", "c2f") != "c2f":
        todo.append((f"--mode {args.mode}", 19))
    if getattr(args, "profile_start_step", -1) is not None \
            and getattr(args, "profile_start_step", -1) >= 0:
        todo.append(("--profile_start_step >= 0 (tracing: the port has no "
                     "trace window yet)", 15))
    if todo:
        raise NotImplementedError(
            "not ported to evdeblurnerf_torch yet: " + "; ".join(
                f"{what} is ROADMAP queue 1 item {item}"
                for what, item in todo))


def resolve_event_thresholds(args: Args) -> Args:
    """Default the per-polarity event thresholds from the shared one
    (ref: run_nerf.py:37-41). Mutates ``args`` in place (callers that must
    not leak the resolution copy first); returns it for chaining. Every
    entry point that feeds thresholds into a model (train, serving export,
    checkpoint convert/export, bench) resolves through here."""
    if args.events_threshold_pos is None or args.events_threshold_neg is None:
        args.events_threshold_pos = args.events_threshold
        args.events_threshold_neg = args.events_threshold
    return args


def write_args_txt(args: Args, path: str):
    """Dump the full resolved flag snapshot (ref: run_nerf.py:151-155)."""
    with open(path, "w") as handle:
        for key in sorted(args.as_dict()):
            handle.write(f"{key} = {getattr(args, key)}\n")
