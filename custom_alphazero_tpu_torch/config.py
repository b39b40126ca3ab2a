"""Configuration tree.

Own copies of the JAX package's config dataclasses, with the same fields and
defaults, the same dotted-key overrides and the same JSON snapshot, so a
configuration file (e.g. ``artifacts/c4-r5/config.json``) reads into either
package and writes back identically. Field comments live with the JAX
originals (custom_alphazero_tpu/config.py). Some fields are the port's
own: ``model.residual_projection`` (default True, the JAX net's block),
``model.se_ratio`` (default 0, no squeeze-excitation gate) and the nested
bottleneck tower's ``model.mid_filters``, ``model.gpool_filters`` and
``model.gpool_blocks`` (default 0, 0 and (): the classic blocks), which
the port's snapshot adds and the JAX package's ``from_json`` passes over.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ConnectNConfig:
    width: int = 7
    height: int = 6
    n: int = 4
    gravity: bool = True

    def __post_init__(self):
        if not 2 <= self.n <= min(self.width, self.height):
            raise ValueError(f"n={self.n} does not fit a "
                             f"{self.width}x{self.height} board")

    @property
    def num_actions(self) -> int:
        # One action per column with gravity; otherwise one per cell,
        # ordered column-major (action = x * height + y).
        return self.width if self.gravity else self.width * self.height


@dataclass(frozen=True)
class ChessConfig:
    history_length: int = 8


@dataclass(frozen=True)
class MCTSConfig:
    simulations: int = 250
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.03
    dirichlet_fraction: float = 0.25
    use_dirichlet: bool = False
    greedy_from_move: int = 8
    use_solver: bool = False
    max_nodes: int = 0
    reuse_tree: bool = False
    topk_actions: int = 0
    use_gumbel: bool = False
    gumbel_max_considered: int = 16
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0
    fast_edge_stats: bool = False


@dataclass(frozen=True)
class ModelConfig:
    depth: int = 4
    filters: int = 128
    policy_filters: int = 2
    value_filters: int = 1
    value_hidden: int = 256
    l2: float = 1e-4
    momentum: float = 0.9
    lr_boundaries: Tuple[int, ...] = (150_000, 300_000)
    lr_values: Tuple[float, ...] = (1e-2, 1e-3, 1e-4)
    batch_size: int = 256
    grad_clip_norm: float = 0.0
    # bfloat16 activations (production on the card); "float32" for parity.
    compute_dtype: str = "bfloat16"
    # Port-only: each residual block adds a 1x1 conv->BN projection of its
    # input (the JAX net's block); False adds the input itself, AlphaGo
    # Zero's and AlphaZero's block.
    residual_projection: bool = True
    # Port-only: > 0 gives each residual block a squeeze-excitation gate
    # (Leela Chess Zero's: two dense layers through filters / se_ratio
    # units, a sigmoid scale and an offset a channel) on its second conv's
    # output; 0 has none. Only with residual_projection=False.
    se_ratio: int = 0
    # Port-only: > 0 makes every block KataGo's pre-activation nested
    # bottleneck (``bottlenest2``): a 1x1 conv from ``filters`` down to
    # ``mid_filters``, two inner residual blocks of two 3x3 convs at that
    # width, a 1x1 conv back up, the block input added; a final norm and
    # ReLU before the heads. 0: the classic blocks above. Only with
    # residual_projection=False and se_ratio=0.
    mid_filters: int = 0
    # Port-only, nested bottleneck blocks only: the pooled channels of a
    # pooled block's first inner block (KataGo's ``bottlenest2gpool``: its
    # first conv splits into mid_filters - gpool_filters regular channels
    # and gpool_filters pooled ones, whose board mean, scaled mean and max
    # become a channel bias of the regular ones), and which blocks pool,
    # numbered from 1.
    gpool_filters: int = 0
    gpool_blocks: Tuple[int, ...] = ()


@dataclass(frozen=True)
class SelfPlayConfig:
    games_per_generation: int = 256
    discount: float = 1.0
    exclude_draws: bool = True
    continuous: bool = False
    max_plies: int = 0


@dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 10_000
    min_size: int = 2_500
    compress_obs: bool = True
    policy_topk: int = 0


@dataclass(frozen=True)
class ArenaConfig:
    games: int = 150
    promote_threshold: float = 0.55
    evaluation_frequency: int = 50
    checkpoint_frequency: int = 50
    evaluate_with_mcts: bool = False
    evaluate_with_solver: bool = False
    deterministic: bool = False
    min_decisives: int = 0
    promote_when_inconclusive: bool = False
    solver_score_veto: bool = False
    solver_score_veto_margin: float = 0.02


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallelism: int = 0
    model_parallelism: int = 1


@dataclass(frozen=True)
class LoopConfig:
    generations: int = 0  # 0 = run forever
    train_iterations_per_generation: int = 8
    checkpoint_replay: bool = True
    samples_checkpoint_frequency: int = 1
    visualize_frequency: int = 0
    solver_labels_path: str = ""
    solver_value_weight: float = 0.25
    solver_policy_weight: float = 0.0
    max_sample_reuse: float = 0.0
    solver_value_batch: int = 256


@dataclass(frozen=True)
class RunConfig:
    results_dir: str = "results"
    run_id: str = ""  # empty = timestamp at startup
    seed: int = 0
    watchdog_minutes: float = 0.0
    compile_grace_minutes: float = 30.0


@dataclass(frozen=True)
class Config:
    game: str = "connect_n"  # "connect_n" | "chess"
    connect_n: ConnectNConfig = field(default_factory=ConnectNConfig)
    chess: ChessConfig = field(default_factory=ChessConfig)
    mcts: MCTSConfig = field(default_factory=MCTSConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    self_play: SelfPlayConfig = field(default_factory=SelfPlayConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    arena: ArenaConfig = field(default_factory=ArenaConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    run: RunConfig = field(default_factory=RunConfig)


# ---------------------------------------------------------------------------
# Overrides & serialization
# ---------------------------------------------------------------------------

def _coerce(value: str, target: Any) -> Any:
    """Coerce a CLI string to the type of the field it replaces."""
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = target[0] if target else 0
        return tuple(_coerce(p.strip(), elem) for p in parts)
    return value


def validate(config: Config) -> Config:
    """Reject foot-gun configs at parse time (returns the config)."""
    m = config.model
    if len(m.lr_values) != len(m.lr_boundaries) + 1:
        raise ValueError(
            f"model.lr_values needs exactly len(lr_boundaries)+1 entries: "
            f"got {len(m.lr_values)} values for {len(m.lr_boundaries)} "
            "boundaries"
        )
    if any(b2 <= b1 for b1, b2 in zip(m.lr_boundaries, m.lr_boundaries[1:])):
        raise ValueError(
            f"model.lr_boundaries must be strictly increasing: {m.lr_boundaries}"
        )
    if m.se_ratio < 0:
        raise ValueError(f"model.se_ratio={m.se_ratio} must be >= 0 (0: no "
                         "squeeze-excitation gate)")
    if m.se_ratio and m.residual_projection:
        raise ValueError(
            "model.se_ratio > 0 gates identity-skip blocks: it needs "
            "model.residual_projection=false")
    if m.se_ratio and m.filters % m.se_ratio:
        raise ValueError(
            f"model.se_ratio={m.se_ratio} does not divide model.filters="
            f"{m.filters}")
    if m.mid_filters < 0 or m.gpool_filters < 0:
        raise ValueError(
            f"model.mid_filters={m.mid_filters} and model.gpool_filters="
            f"{m.gpool_filters} must be >= 0 (0: none)")
    if m.mid_filters and (m.se_ratio or m.residual_projection):
        raise ValueError(
            "model.mid_filters > 0 builds nested bottleneck blocks, which "
            "carry their own skips: it needs model.residual_projection=false "
            "and model.se_ratio=0")
    if (m.gpool_filters or m.gpool_blocks) and not m.mid_filters:
        raise ValueError(
            "model.gpool_filters and model.gpool_blocks pool inside nested "
            "bottleneck blocks: they need model.mid_filters > 0")
    if bool(m.gpool_filters) != bool(m.gpool_blocks):
        raise ValueError(
            f"model.gpool_filters={m.gpool_filters} and model.gpool_blocks="
            f"{m.gpool_blocks}: a pooled block needs both")
    if m.gpool_filters and m.gpool_filters >= m.mid_filters:
        raise ValueError(
            f"model.gpool_filters={m.gpool_filters} leaves no regular channel"
            f" of model.mid_filters={m.mid_filters}")
    if any(not 1 <= b <= m.depth for b in m.gpool_blocks) or len(
            set(m.gpool_blocks)) != len(m.gpool_blocks):
        raise ValueError(
            f"model.gpool_blocks={m.gpool_blocks}: distinct block numbers "
            f"from 1 to model.depth={m.depth}")
    if config.arena.solver_score_veto and not (
        config.arena.evaluate_with_solver and config.game == "connect_n"
    ):
        raise ValueError(
            "arena.solver_score_veto needs arena.evaluate_with_solver=true "
            "on connect_n (the oracle scores arena moves there)"
        )
    s = config.mcts
    if s.max_nodes and s.max_nodes < s.simulations:
        raise ValueError(
            f"mcts.max_nodes={s.max_nodes} < mcts.simulations="
            f"{s.simulations}: the tree needs one slot per simulation "
            "(set max_nodes=0 for auto)"
        )
    if s.topk_actions < -1:
        raise ValueError(
            f"mcts.topk_actions={s.topk_actions}: use 0 (auto), -1 (full "
            "width) or an explicit positive top-K prior width"
        )
    if s.simulations < 1:
        raise ValueError(f"mcts.simulations={s.simulations} must be >= 1")
    return config


def apply_overrides(config: Config, overrides: dict) -> Config:
    """Apply {"mcts.simulations": "64", ...} dotted-key overrides."""
    for dotted, raw in overrides.items():
        keys = dotted.split(".")
        # Walk down to the leaf dataclass, then rebuild the spine.
        objs = [config]
        for key in keys[:-1]:
            objs.append(getattr(objs[-1], key))
        current = getattr(objs[-1], keys[-1])
        value = _coerce(raw, current) if isinstance(raw, str) else raw
        updated = dataclasses.replace(objs[-1], **{keys[-1]: value})
        for obj, key in zip(reversed(objs[:-1]), reversed(keys[:-1])):
            updated = dataclasses.replace(obj, **{key: updated})
        config = updated
    return validate(config)


def parse_cli_overrides(argv: list) -> dict:
    """Parse ["--mcts.simulations=64", ...] style args."""
    overrides = {}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"Expected --dotted.key=value, got {arg!r}")
        key, _, value = arg[2:].partition("=")
        overrides[key] = value
    return overrides


def to_json(config: Config) -> str:
    return json.dumps(dataclasses.asdict(config), indent=2, sort_keys=True)


def from_json(text: str) -> Config:
    """A Config from a JSON snapshot; absent fields keep their defaults."""
    data = json.loads(text)
    kwargs: dict = {}
    for f in dataclasses.fields(Config):
        if f.name not in data:
            continue
        value = data[f.name]
        if isinstance(value, dict):
            sub = type(getattr(Config(), f.name))
            value = sub(**{
                sf.name: (tuple(value[sf.name])
                          if isinstance(value[sf.name], list)
                          else value[sf.name])
                for sf in dataclasses.fields(sub) if sf.name in value
            })
        kwargs[f.name] = value
    return Config(**kwargs)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never carries on on the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.index is None:  # tensors report their card's index
        device = torch.device("cuda", torch.cuda.current_device())
    return device
