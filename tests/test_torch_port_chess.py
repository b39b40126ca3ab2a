"""The port's chess engine and perft against the JAX package's.

- The tables are array-equal to JAX's (the Zobrist tables included).
- Perft equals JAX's ``tools/perft.py`` and the published counts.
- Random games driven by the same actions in both engines: every state
  field (the hash ring as uint32 bits) equal after every ply, and the
  observations bit-equal. All of it is integer arithmetic: exact.
- The rule cases of tests/test_chess.py, each state equal to JAX's after
  every move.
- Legality against the naive checker of tests/reference_chess.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.envs.chess import tables as JT
from custom_alphazero_tpu.envs.chess.engine import Chess as JaxChess
from custom_alphazero_tpu.tools.perft import perft as jax_perft
from custom_alphazero_tpu_torch.envs.chess import tables as T
from custom_alphazero_tpu_torch.envs.chess.engine import Chess, ChessState
from custom_alphazero_tpu_torch.tools.perft import perft
from tests import reference_chess
from tests.test_chess import KNOWN_PERFTS

JENV = JaxChess()
ENV = Chess()
JSTEP = jax.jit(JENV.step)
JSTEP_BATCH = jax.jit(jax.vmap(JENV.step))
JOBSERVE = jax.jit(jax.vmap(JENV.observe))
FIELDS = [f.name for f in dataclasses.fields(ChessState)]


def to_torch(jstate) -> ChessState:
    """A JAX state (batched) as the port's, uint32 hashes as int32 bits."""
    def conv(x):
        x = np.array(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                else x)

    return ChessState(**{f: conv(getattr(jstate, f)) for f in FIELDS})


def assert_same_state(state: ChessState, jstate, where: str) -> None:
    want = to_torch(jstate)
    for name in FIELDS:
        got, ref = getattr(state, name), getattr(want, name)
        assert got.dtype == ref.dtype, f"{where}: {name} dtype"
        assert torch.equal(got, ref), f"{where}: {name} differs"


def batch1(jstate):
    return jax.tree.map(lambda x: x[None], jstate)


def test_tables_equal_jax():
    assert T.NUM_ACTIONS == JT.NUM_ACTIONS == 1968
    assert T.ACTION_UCI == JT.ACTION_UCI
    for name in ("FROM", "TO", "PROMO", "DIR", "DIST", "IS_KNIGHT",
                 "BETWEEN", "RAY", "KNIGHT_TARGETS", "KING_TARGETS",
                 "OPP_PAWN_FROM", "ZOBRIST", "ZOBRIST_CASTLE", "ZOBRIST_EP",
                 "START_BOARD"):
        got, want = getattr(T, name), getattr(JT, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("CASTLE_K", "CASTLE_Q", "E1", "C1", "D1", "F1", "G1", "B1",
                 "A1", "H1", "A8", "H8", "E8"):
        assert getattr(T, name) == getattr(JT, name), name
    fen = "r2q1rk1/pP1p2pp/Q4n2/bbp1p3/Np6/1B3NBn/pPPP1PPP/R3K2R b KQ - 0 1"
    for got, want in zip(T.board_from_fen(fen), JT.board_from_fen(fen)):
        np.testing.assert_array_equal(got, want)
    assert T.mirror_uci("e2e4") == JT.mirror_uci("e2e4") == "e7e5"
    with pytest.raises(ValueError, match="one king"):
        T.board_from_fen("8/8/8/8/8/8/8/K7 w - - 0 1")


@pytest.mark.parametrize("fen,counts", KNOWN_PERFTS,
                         ids=[f[0][:18] for f in KNOWN_PERFTS])
def test_perft_matches_jax_and_published(fen, counts):
    root = ENV.init(1, "cpu") if fen == "start" else ENV.from_fen(fen, "cpu")
    jroot = JENV.init() if fen == "start" else JENV.from_fen(fen)
    assert_same_state(root, batch1(jroot), "root")
    for depth, want in enumerate(counts, start=1):
        got = perft(ENV, root, depth, chunk=256)
        assert got == want == jax_perft(JENV, jroot, depth), (fen, depth)


def test_perft_deep():
    """The two deep published counts (tests/test_chess.py slow-marks them
    for the JAX engine; here they take seconds)."""
    assert perft(ENV, ENV.init(1, "cpu"), 4) == 197_281
    kiwi = ENV.from_fen(KNOWN_PERFTS[1][0], "cpu")
    assert perft(ENV, kiwi, 3) == 97_862


def test_perft_cli(capsys):
    from custom_alphazero_tpu_torch.tools import perft as perft_tool

    perft_tool.main(["start", "2", "--device=cpu"])
    assert capsys.readouterr().out.strip() == "400"


def test_random_games_match_jax():
    """4 games x 60 plies from the same random legal actions: every field
    and the observation equal after every ply."""
    batch, plies = 4, 60
    rng = np.random.default_rng(11)
    jstate = jax.vmap(lambda _: JENV.init())(jnp.arange(batch))
    state = ENV.init(batch, "cpu")
    assert_same_state(state, jstate, "init")
    captures = 0
    for ply in range(plies):
        legal = ENV.legal_mask(state).numpy()
        actions = np.array([rng.choice(np.nonzero(row)[0]) if row.any()
                            else 0 for row in legal])
        captures += int((state.board.view(batch, 64).numpy()[
            np.arange(batch), T.TO[actions]] < 0).sum())
        jstate, jreward = JSTEP_BATCH(jstate, jnp.asarray(actions, jnp.int32))
        state, reward = ENV.step(state, torch.from_numpy(actions))
        assert_same_state(state, jstate, f"ply {ply}")
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        obs = ENV.observe(state).numpy()
        assert obs.dtype == np.float32 and obs.shape == (batch, 8, 8, 118)
        assert obs.tobytes() == np.asarray(JOBSERVE(jstate)).tobytes()
    assert captures > 0


def test_step_lite_matches_jax():
    """The descent step: same fields as JAX's (analysis fields stale)."""
    rng = np.random.default_rng(2)
    jstate = jax.vmap(lambda _: JENV.init())(jnp.arange(3))
    state = ENV.init(3, "cpu")
    jlite = jax.jit(jax.vmap(JENV.step_lite))
    for ply in range(12):
        legal = ENV.legal_mask(state).numpy()
        actions = np.array([rng.choice(np.nonzero(row)[0]) for row in legal])
        assert_same_state(ENV.step_lite(state, torch.from_numpy(actions)),
                          jlite(jstate, jnp.asarray(actions, jnp.int32)),
                          f"lite ply {ply}")
        jstate, _ = JSTEP_BATCH(jstate, jnp.asarray(actions, jnp.int32))
        state, _ = ENV.step(state, torch.from_numpy(actions))


# The rule cases of tests/test_chess.py: (FEN or "start", moves in absolute
# UCI, checks on the final port state).
def _terminal(won):
    def check(s):
        assert bool(s.terminal[0]) and bool(s.won[0]) == won
    return check


def _legal_has(present=(), absent=()):
    def check(s):
        legal = ENV.legal_mask(s)[0]
        for uci in present:
            assert legal[T.ACTION_INDEX[uci]], uci
        for uci in absent:
            assert not legal[T.ACTION_INDEX[uci]], uci
    return check


RULE_CASES = {
    "fools-mate": ("start", ["f2f3", "e7e5", "g2g4", "d8h4"], _terminal(True)),
    "stalemate": ("7k/5Q2/6K1/8/8/8/8/8 b - - 0 1", [], _terminal(False)),
    "en-passant": ("k7/8/8/3pP3/8/8/8/K7 w - d6 0 2", ["e5d6"],
                   lambda s: int((s.board != 0).sum()) == 3 or pytest.fail()),
    "ep-rank-pin": ("7k/8/8/KPp4r/8/8/8/8 w - c6 0 2", [],
                    _legal_has(["b5b6"], ["b5c6"])),
    "capture-promotion": ("rn5k/P7/8/8/8/8/8/4K3 w - - 0 1", ["a7b8q"],
                          lambda s: int(s.board[0, 0, 1]) == -T.QUEEN
                          or pytest.fail()),
    "castle-kingside": ("4k3/8/8/8/8/8/8/R3K2R w KQ - 0 1", ["e1g1"],
                        lambda s: (int(s.board[0, 7, 6]), int(s.board[0, 7, 5]))
                        == (-T.KING, -T.ROOK) or pytest.fail()),
    "castle-queenside": ("r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1",
                         ["e1c1", "e8g8"], _legal_has()),
    "castle-in-check": ("4k3/8/8/8/8/8/4r3/R3K2R w KQ - 0 1", [],
                        _legal_has([], ["e1g1", "e1c1"])),
    "castle-attacked-square": ("4k3/8/8/8/8/5r2/8/R3K2R w KQ - 0 1", [],
                               _legal_has(["e1c1"], ["e1g1"])),
    "castle-no-rights": ("4k3/8/8/8/8/8/8/R3K2R w - - 0 1", [],
                         _legal_has([], ["e1g1", "e1c1"])),
    "rook-capture-rights": ("r3k2r/8/8/8/8/8/6B1/4K3 w kq - 0 1", ["g2a8"],
                            lambda s: s.castling[0, :2].tolist()
                            == [True, False] or pytest.fail()),
    "insufficient-bare": ("8/8/8/4k3/8/8/8/K7 w - - 0 1", [],
                          _terminal(False)),
    "insufficient-minor": ("8/8/8/4kn2/8/8/8/K7 w - - 0 1", [],
                           _terminal(False)),
    "sufficient-rook": ("8/8/8/4kr2/8/8/8/K7 w - - 0 1", ["a1b1"],
                        lambda s: not bool(s.terminal[0]) or pytest.fail()),
    "threefold": ("k7/8/8/8/8/8/7R/K7 w - - 0 1",
                  ["h2g2", "a8b8", "g2h2", "b8a8"] * 2, _terminal(False)),
    "fen-sanitised": ("4k3/8/8/8/8/8/8/4K3 w KQkq - 0 1", [],
                      lambda s: not bool(s.castling.any()) or pytest.fail()),
    "expired-halfmove": ("8/8/8/4k3/8/8/4K3/4R3 w - - 150 100", [],
                         _terminal(False)),
    "phantom-ep": ("4k3/8/8/8/4p3/8/3P4/4K3 w - - 0 1", ["d2d4", "e8d8"],
                   _legal_has()),
    "castle-ids-queen-moves": ("4k3/8/8/8/8/8/8/4Q2K w - - 0 1", [],
                               lambda s: int(ENV.legal_mask(s).sum()) == 23
                               or pytest.fail()),
    "push-promotion": ("4k3/2P5/8/8/8/8/7P/4K3 w - - 0 1", ["c7c8n", "e8f7"],
                       _legal_has()),
    "promotion-capture-d8": ("3nk3/2P5/8/8/8/8/8/4K3 w - - 0 1", ["c7d8q"],
                             lambda s: bool(s.in_check[0]) or pytest.fail()),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_cases_match_jax(case):
    fen, moves, check = RULE_CASES[case]
    state = ENV.init(1, "cpu") if fen == "start" else ENV.from_fen(fen, "cpu")
    jstate = JENV.init() if fen == "start" else JENV.from_fen(fen)
    assert_same_state(state, batch1(jstate), "loaded")
    white = fen == "start" or fen.split()[1] == "w"
    for uci in moves:
        action = T.ACTION_INDEX[uci if white else T.mirror_uci(uci)]
        assert bool(ENV.legal_mask(state)[0, action]), uci
        jstate, jreward = JSTEP(jstate, jnp.int32(action))
        state, reward = ENV.step(state, torch.tensor([action]))
        assert_same_state(state, batch1(jstate), uci)
        assert float(reward[0]) == float(jreward)
        white = not white
    check(state)


def test_legality_matches_reference_checker():
    """The pin/check legality against tests/reference_chess.py's naive
    per-move simulation along random games."""
    rng = np.random.default_rng(17)
    state = ENV.init(3, "cpu")
    positions = 0
    for ply in range(40):
        legal = ENV.legal_mask(state).numpy()
        for g in range(3):
            if bool(state.terminal[g]):
                continue
            want, want_check = reference_chess.legal_mask(
                state.board[g].numpy(), state.castling[g].numpy(),
                int(state.ep_file[g]))
            np.testing.assert_array_equal(legal[g], want,
                                          err_msg=f"game {g} ply {ply}")
            assert bool(state.in_check[g]) == want_check
            positions += 1
        actions = np.array([rng.choice(np.nonzero(row)[0]) if row.any()
                            else 0 for row in legal])
        state, _ = ENV.step(state, torch.from_numpy(actions))
    assert positions > 100


def test_state_batch_helpers():
    state = ENV.from_fen([KNOWN_PERFTS[1][0], KNOWN_PERFTS[2][0]], "cpu")
    assert state.board.shape == (2, 8, 8)
    both = ChessState.cat([state.take(torch.tensor([1])),
                           state.take(torch.tensor([0]))])
    assert torch.equal(both.board, state.board.flip(0))
    mixed = state.where(torch.tensor([True, False]), both)
    assert torch.equal(mixed.legal[0], state.legal[0])
    assert torch.equal(mixed.legal[1], state.legal[0])
