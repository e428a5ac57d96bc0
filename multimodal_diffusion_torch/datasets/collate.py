"""Batch collation + target selection (host-side numpy; a copy of the JAX
package's ``datasets/collate.py``, which the port may not import).

Parity with the reference `avdiff/models/train/collate.py:102-211`:
  * video padded/cropped to exactly T_target frames (repeat last frame when
    short, truncate when long — _pad_video, collate.py:31-43)
  * audio zero-padded/cropped to exactly L_target samples (46-57)
  * missing modalities zero-filled with has_video/has_audio bool masks
  * target normalization with existence fallback (_decide_target, 60-99)

Static output shapes by construction: every step sees the same shapes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Union

import numpy as np

TargetLike = Optional[Union[str, Set[str], Callable[[], Union[str, Set[str]]]]]


def _pad_video(v: np.ndarray, T: int) -> np.ndarray:
    """Pad/crop time axis (axis 1 for [3,T,H,W] f32, axis 0 for the uint8
    device-preprocess layout [T,H,W,3]) by repeating the last frame."""
    t_axis = 0 if v.dtype == np.uint8 else 1
    t0 = v.shape[t_axis]
    if t0 == T:
        return v
    idx = [slice(None)] * v.ndim
    if t0 > T:
        idx[t_axis] = slice(0, T)
        return v[tuple(idx)]
    idx[t_axis] = slice(-1, None)
    last = np.repeat(v[tuple(idx)], T - t0, axis=t_axis)
    return np.concatenate([v, last], axis=t_axis)


def _pad_audio(a: np.ndarray, L: int) -> np.ndarray:
    l0 = a.shape[-1]
    if l0 == L:
        return a
    if l0 > L:
        return a[..., :L]
    return np.concatenate([a, np.zeros((1, L - l0), a.dtype)], axis=-1)


def _fit_hw(v: np.ndarray, H: int, W: int) -> np.ndarray:
    """Pad right/bottom then truncate so spatial dims are exactly (H, W)."""
    h, w = v.shape[-2], v.shape[-1]
    if (h, w) == (H, W):
        return v
    if h < H or w < W:
        v = np.pad(v, ((0, 0), (0, 0), (0, max(0, H - h)), (0, max(0, W - w))))
    return v[..., :H, :W]


def _decide_target(pick_target: TargetLike, has_video: bool,
                   has_audio: bool) -> Set[str]:
    target = pick_target() if callable(pick_target) else pick_target
    if isinstance(target, str):
        target_set = {target}
    elif isinstance(target, set):
        target_set = target
    elif target is None:
        if has_video and has_audio:
            target_set = {"audio"} if np.random.random() < 0.5 else {"video"}
        elif has_video:
            target_set = {"video"}
        else:
            target_set = {"audio"}
    else:
        raise ValueError(f"Unsupported target type: {type(target)}")
    if "video" in target_set and not has_video and has_audio:
        return {"audio"}
    if "audio" in target_set and not has_audio and has_video:
        return {"video"}
    return target_set


def collate_batch(
    items: List[Dict[str, Any]],
    T_target: int,
    L_target: int,
    pick_target: TargetLike = None,
    default_hw: tuple = (128, 128),
) -> Dict[str, Any]:
    """Returns {"video" [B,3,T,H,W] | None, "audio" [B,1,L] | None,
    "has_video" [B] bool, "has_audio" [B] bool, "target" set, "meta" list}."""
    vids, auds, metas, has_v, has_a = [], [], [], [], []
    H = W = None
    u8_mode = False
    for it in items:
        v, a = it.get("video"), it.get("audio")
        if v is not None:
            v = np.asarray(v)
            if v.dtype == np.uint8:
                # device-preprocess layout [T, H, W, 3]
                if v.ndim != 4 or v.shape[-1] != 3:
                    raise ValueError(f"uint8 video must be [T,H,W,3]; got {v.shape}")
                u8_mode = True
                if H is None:
                    H, W = int(v.shape[1]), int(v.shape[2])
            else:
                v = v.astype(np.float32)
                if v.ndim != 4 or v.shape[0] != 3:
                    raise ValueError(f"video must be [3,T,H,W]; got {v.shape}")
                if H is None:
                    H, W = int(v.shape[-2]), int(v.shape[-1])
        if a is not None:
            a = np.asarray(a, np.float32)
            if a.ndim != 2 or a.shape[0] != 1:
                raise ValueError(f"audio must be [1,L]; got {a.shape}")
        vids.append(v)
        auds.append(a)
        metas.append(it.get("meta", {}))
        has_v.append(v is not None)
        has_a.append(a is not None)

    any_v, any_a = any(has_v), any(has_a)
    if not any_v and H is None:
        H, W = default_hw

    v_batch = None
    if any_v:
        filled = []
        for v in vids:
            if v is None:
                v = (np.zeros((T_target, H, W, 3), np.uint8) if u8_mode
                     else np.zeros((3, T_target, H, W), np.float32))
            elif u8_mode:
                v = _pad_video(v[:, :H, :W, :], T_target)
            else:
                v = _pad_video(_fit_hw(v, H, W), T_target)
            filled.append(v)
        v_batch = np.stack(filled, axis=0)

    a_batch = None
    if any_a:
        filled = []
        for a in auds:
            if a is None:
                a = np.zeros((1, L_target), np.float32)
            else:
                a = _pad_audio(a, L_target)
            filled.append(a)
        a_batch = np.stack(filled, axis=0)

    return {
        "video": v_batch,
        "audio": a_batch,
        "has_video": np.asarray(has_v, bool),
        "has_audio": np.asarray(has_a, bool),
        "target": _decide_target(pick_target, any_v, any_a),
        "meta": metas,
    }
