"""MCTS tree rendering (the port of tools/visualize.py).

Breadth-first walk of one game's search tree; nodes are drawn as monospace
board diagrams, edges annotated with UCT / Q (exploitation) / U
(exploration) / P (prior) / N (visits) and the visit share among siblings;
the played edge is red, a greedily played one bold; edges below
``min_visits`` are pruned. The DOT text is byte-equal to the JAX
package's for the same tree (tests/test_torch_port_supervise.py). The tree
is copied to the host once and the nodes' boards are replayed on the host,
with the env on the CPU; PDF output needs the optional ``graphviz``
package and is best-effort.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from custom_alphazero_tpu_torch.search.mcts import UNVISITED, Tree


def _board_label(board: np.ndarray) -> str:
    """ASCII board; also draws the chess int8 array."""
    symbols = {0: " . ", 1: " X ", -1: " O "}
    chess = {1: " P ", 2: " N ", 3: " B ", 4: " R ", 5: " Q ", 6: " K ",
             -1: " p ", -2: " n ", -3: " b ", -4: " r ", -5: " q ", -6: " k ",
             0: " . "}
    table = symbols if set(np.unique(board)) <= {-1, 0, 1} else chess
    rows = ["".join(table[int(v)] for v in row) for row in board]
    return "\\n".join(rows)


def _host_tree(tree: Tree, game_index: int) -> SimpleNamespace:
    """Game ``game_index`` of ``tree`` on the host: numpy arrays, and the
    root state as a batch of one on the CPU."""
    fields = {name: value[game_index].cpu().numpy()
              for name, value in vars(tree).items()
              if isinstance(value, torch.Tensor)}
    fields["root_state"] = type(tree.root_state)(*(
        t[game_index:game_index + 1].cpu()
        for t in vars(tree.root_state).values()))
    return SimpleNamespace(**fields)


def _replay_boards(env, t) -> np.ndarray:
    """Each node's board, replayed along the parent-action chains from the
    root (nodes are created parent-first, so one ascending pass suffices);
    the tree stores no per-node states. Unlinked slots (parent -1) get the
    root's board and are never rendered."""
    states = [t.root_state]
    boards = [t.root_state.board[0].numpy()]
    for i in range(1, t.parent.shape[0]):
        parent = int(t.parent[i])
        if parent < 0:
            states.append(states[0])
            boards.append(boards[0])
            continue
        child, _ = env.step(states[parent],
                            torch.tensor([int(t.parent_action[i])]))
        states.append(child)
        boards.append(child.board[0].numpy())
    return np.stack(boards)


def _children_table(t, a_count: int) -> np.ndarray:
    """(N, A) child-index table (UNVISITED where absent), rebuilt from the
    parent/parent_action vectors."""
    n = t.parent.shape[0]
    children = np.full((n, a_count), UNVISITED, np.int64)
    for c in range(1, n):
        p = int(t.parent[c])
        if p >= 0:
            children[p, int(t.parent_action[c])] = c
    return children


def tree_to_dot(
    tree: Tree,
    env,
    game_index: int = 0,
    c_puct: float = 1.5,
    min_visits: int = 1,
    played_action: Optional[int] = None,
    greedy: bool = False,
    max_nodes: int = 400,
) -> str:
    """Render one game's search tree to DOT text.

    min_visits: prune edges with fewer visits (1 keeps the visited edges,
    the 'light' render; 0 keeps every created edge, the 'full' one).
    """
    t = _host_tree(tree, game_index)
    n_alloc = t.parent.shape[0]
    boards = _replay_boards(env, t)
    a_count = env.num_actions

    lines = [
        "digraph MCTS {",
        '  node [shape=box, fontname="Courier"];',
        '  edge [fontname="Helvetica", fontsize=9];',
    ]
    emitted = set()

    def emit_node(i):
        if i in emitted:
            return
        emitted.add(i)
        label = _board_label(boards[i])
        extra = f"\\nv={t.value_evaluated[i]:+.2f}" if t.expanded[i] else ""
        lines.append(f'  n{i} [label="{label}{extra}"];')

    children_flat = _children_table(t, a_count)
    if t.prior.shape[-1] != a_count:
        # Top-K tree: scatter the per-node (K,) rows back to full width;
        # the root keeps its full row in root_prior.
        priors_flat = np.zeros((n_alloc, a_count), np.float32)
        np.put_along_axis(priors_flat, t.prior_acts.astype(np.int64),
                          t.prior, -1)
        priors_flat[0] = t.root_prior
    else:
        priors_flat = t.prior.reshape(-1, a_count)
    queue = [0]
    visited = {0}
    while queue and len(emitted) < max_nodes:
        node = queue.pop(0)
        if not t.expanded[node]:
            continue
        children = children_flat[node]
        child_visits = np.where(
            children >= 0, t.visits[np.maximum(children, 0)], 0
        )
        total = child_visits.sum()
        sqrt_total = np.sqrt(total)
        for action, child in enumerate(children):
            if child == UNVISITED or child >= n_alloc:
                continue
            nv = int(t.visits[child])
            is_played = node == 0 and played_action == action
            if nv < min_visits and not is_played:
                continue
            q = float(t.value_sum[child]) / nv if nv else 0.0
            p = float(priors_flat[node, action])
            u = c_puct * p * sqrt_total / (1 + nv)
            share = nv / total if total else 0.0
            emit_node(node)
            emit_node(child)
            attrs = [
                f'label="a={action} UCT={q + u:.2f}\\nQ={q:+.2f} U={u:.2f}'
                f'\\nP={p:.2f} N={nv} {share:.0%}"'
            ]
            if is_played:
                attrs.append("color=red")
                if greedy:
                    attrs.append("penwidth=3")
            lines.append(f"  n{node} -> n{child} [{', '.join(attrs)}];")
            if child not in visited:
                visited.add(child)
                queue.append(child)
    lines.append("}")
    return "\n".join(lines)


def save_tree(
    tree: Tree,
    env,
    path: str,
    game_index: int = 0,
    render_pdf: bool = True,
    **kwargs,
) -> str:
    """Write `<path>.dot` (and `<path>.pdf` when graphviz is available).
    Returns the DOT path."""
    dot = tree_to_dot(tree, env, game_index, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dot_path = path + ".dot"
    with open(dot_path, "w") as fp:
        fp.write(dot)
    if render_pdf:
        try:
            import graphviz

            graphviz.Source(dot).render(path, format="pdf", cleanup=True)
        except Exception:  # noqa: BLE001 (rendering is best-effort)
            pass
    return dot_path
