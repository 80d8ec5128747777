"""Checkpointing with ``torch.save``: best / periodic snapshots + full resume.

Counterpart of ``fedicra_tpu/utils/checkpoint.py`` (orbax there), with the
same artifact names in the snapshot directory: ``best_global`` and
``best_info.txt`` (the server's aggregate best), ``best_client_{cid}`` and
``best_client_{cid}_info.txt`` (each client's own best), ``iter_{n}_global``
(periodic) and ``resume``. The reference only ever saves
(flower_common.py:341-381); the resume snapshot lets a run restart mid-way.

Each artifact is one file holding a nested dict of tensors and Python
scalars; ``torch.load`` reads it back with ``weights_only=True``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def client_state_tree(state) -> Dict[str, Any]:
    """A ``ClientState`` as a dict of its fields, the generator by its state."""
    return {
        "params": state.params,
        "batch_stats": state.batch_stats,
        "current_iter": int(state.current_iter),
        "generator": state.generator.get_state(),
    }


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _save(self, name: str, tree: Any):
        path = os.path.join(self.directory, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)  # a reader never sees half a file

    def _restore(self, name: str, map_location=None) -> Any:
        path = os.path.join(self.directory, name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return torch.load(path, map_location=map_location, weights_only=True)

    def save_best(self, global_payload, round_idx: int, dice: float):
        """Server-side AGGREGATE-best artifact: the global payload at the
        round where the weighted mean val dice peaked. Per-client states are
        not snapshotted here; each client saves its own best via
        :meth:`save_client_best` (reference semantics)."""
        self._save("best_global", {"payload": global_payload})
        with open(os.path.join(self.directory, "best_info.txt"), "w") as f:
            f.write(f"round={round_idx} dice={dice:.6f}\n")

    def save_client_best(self, cid: int, state, round_idx: int, dice: float):
        """Client ``cid``'s state at ITS OWN best ``val_mean_dice`` (the
        reference's BaseClient._validate, flower_common.py:106-114). The info
        file gains one line per improvement."""
        self._save(f"best_client_{cid}", {"state": client_state_tree(state)})
        info = os.path.join(self.directory, f"best_client_{cid}_info.txt")
        with open(info, "a") as f:
            f.write(f"iter={round_idx} dice={dice:.6f}\n")

    def save_periodic(self, global_payload, round_idx: int):
        self._save(f"iter_{round_idx}_global", {"payload": global_payload})

    def save_resume(self, server_state: Dict):
        self._save("resume", server_state)

    def restore_resume(self, map_location=None) -> Optional[Dict]:
        try:
            return self._restore("resume", map_location)
        except FileNotFoundError:
            return None

    def restore_best_global(self, map_location=None) -> Any:
        return self._restore("best_global", map_location)["payload"]

    def restore_best_client(self, cid: int, map_location=None) -> Dict[str, Any]:
        """Client ``cid``'s own-best state tree (see :func:`client_state_tree`)."""
        return self._restore(f"best_client_{cid}", map_location)["state"]
