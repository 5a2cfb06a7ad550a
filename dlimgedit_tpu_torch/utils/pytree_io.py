"""Flat .npz (de)serialisation of parameter trees (counterpart of
dlimgedit_tpu/utils/pytree_io.py; the same file format, so one bundle serves
both packages).

Nested dicts/lists flatten to path keys ("encoder/stages/0/blocks/1/conv1/w").
Format contract (enforced at save time — each would otherwise corrupt the
tree silently on load):
  * keys must not contain "/" (the path separator);
  * all-digit dict keys are reserved for list indices;
  * empty dicts/lists cannot round-trip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np

Tree = Union[Dict[str, Any], List[Any], np.ndarray]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            raise ValueError(
                f"empty dict at '{prefix[:-1]}' cannot round-trip through "
                f"the flat .npz format")
        if all(isinstance(k, str) and k.isdigit() for k in tree):
            raise ValueError(
                f"dict at '{prefix[:-1]}' has all-digit keys, which load "
                f"back as a LIST — rename the keys or use a list")
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(
                    f"key '{k}' at '{prefix[:-1]}' contains '/', the flat-"
                    f"path separator — the tree would unflatten differently")
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            raise ValueError(
                f"empty list at '{prefix[:-1]}' cannot round-trip through "
                f"the flat .npz format")
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Tree:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node, where=""):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            missing = [i for i in range(len(keys)) if str(i) not in node]
            if missing:
                raise ValueError(
                    f"list at '{where}' has gaps (missing indices "
                    f"{missing}) — corrupt or hand-edited bundle?")
            return [listify(node[str(i)], f"{where}/{i}")
                    for i in range(len(keys))]
        return {k: listify(v, f"{where}/{k}") for k, v in node.items()}

    return listify(root)


def save_pytree(path, tree: Tree) -> None:
    # Through a file object so the target path is used EXACTLY (np.savez
    # given a bare path appends ".npz" silently).
    flat = flatten_tree(tree)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_pytree(path) -> Tree:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
