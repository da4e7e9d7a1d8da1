"""Sort Transform of the no-native engine.

The forward transform is ``ops/st.st_encode`` on the caller's device.  The
inverse is a numpy port of the native group-refinement and backward
LF-walk (native/st.cc:145-349, reference st/st.cpp:1014-1527): the group
marking rounds are vectorized; the final reconstruction walk is serial
(each step depends on a decrementing tie counter) and runs as a Python
loop: slow, but bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch


def st_encode(data: np.ndarray, k: int, device) -> int:
    """Forward ST-k in place.  Returns the index or -1."""
    from ..ops.st import st_encode as _enc

    n = len(data)
    if n <= 1:
        return 0
    if not 3 <= k <= 8:
        return -1
    out, idx = _enc(torch.from_numpy(np.ascontiguousarray(data)).to(device),
                    k)
    data[:] = out.cpu().numpy()
    return int(idx)


def _mark_groups(T: np.ndarray, k: int):
    """Order-(k-1) context-group start flags (native/st.cc:145-213).

    Returns (P uint32[n] with nonzero at group starts, count int64[256]).
    """
    n = len(T)
    P = np.zeros(n, dtype=np.uint32)
    cnt = np.bincount(T, minlength=256).astype(np.int64)
    count = np.concatenate([[0], np.cumsum(cnt)[:-1]])

    # order-2 bucket matrix: bucket[c1, c2] = |{i: first byte bucket c1,
    # output byte c2}| transposed to context counts
    bucket = np.zeros((256, 256), dtype=np.int64)
    bounds = np.concatenate([count, [n]])
    for c in range(256):
        seg = T[bounds[c]:bounds[c + 1]]
        if len(seg):
            bucket[c] = np.bincount(seg, minlength=256)
    bucket = bucket.T.copy()  # bucket[c1, c2] = count of order-2 ctx (c1,c2)

    flat = bucket.reshape(-1)
    if k == 3:
        starts = np.concatenate([[0], np.cumsum(flat)[:-1]])[flat > 0]
        P[starts] = 1
        return P, count

    # order-3 starts: one stable LF pass over order-2 groups (vectorized:
    # position i belongs to order-2 group g2[i]; its LF target is
    # count[T[i]] + occ(T[i], i); a start is the first occurrence of each
    # (T[i], g2) pair in i order)
    g2 = np.repeat(np.arange(65536), flat)  # order-2 group id per position
    order = np.lexsort((np.arange(n), T))   # stable by symbol
    occ_pos = np.empty(n, dtype=np.int64)
    occ_pos[order] = np.arange(n) - count[T[order]]
    lf = count[T] + occ_pos
    # first (T[i], g2[i]) occurrence in increasing i marks P[lf[i]]
    pair = T.astype(np.int64) * 65536 + g2
    first = np.zeros(n, dtype=bool)
    srt = np.lexsort((np.arange(n), pair))
    ps = pair[srt]
    head = np.concatenate([[True], ps[1:] != ps[:-1]])
    first[srt[head]] = True
    P[lf[first]] |= 0x80000000

    # refine to order-(k-1): same marking against the previous round's groups
    mask0, mask1 = 0x80000000, 0x40000000
    for _ in range(4, k):
        gprev = np.cumsum((P & mask0) != 0) - 1
        pair = T.astype(np.int64) * n + gprev
        srt = np.lexsort((np.arange(n), pair))
        ps = pair[srt]
        head = np.concatenate([[True], ps[1:] != ps[:-1]])
        first = np.zeros(n, dtype=bool)
        first[srt[head]] = True
        np.add.at(P, lf[first], np.uint32(mask1))
        mask0 >>= 1
        mask1 >>= 1
    return P, count


def st_decode(data: np.ndarray, k: int, index: int) -> int:
    n = len(data)
    if n < 0 or not 3 <= k <= 8:
        return -1
    if n <= 1:
        return 0
    if index < 0 or index >= n:
        return -1

    T = data.astype(np.uint8)
    P, count = _mark_groups(T, k)

    # build links (layout of native/st.cc:216-241 generalized to int64)
    gstart = np.where(P > 0, np.arange(n), 0)
    gstart = np.maximum.accumulate(gstart)  # group start per position

    # leader per (char, group): first position of each char in its group
    pair = T.astype(np.int64) * n + gstart
    srt = np.lexsort((np.arange(n), pair))
    ps = pair[srt]
    head = np.concatenate([[True], ps[1:] != ps[:-1]])
    leader_of = np.empty(n, dtype=np.int64)
    # leader index for each sorted run
    run_id = np.cumsum(head) - 1
    leaders = srt[head]
    leader_of[srt] = leaders[run_id]

    occ_pos = np.empty(n, dtype=np.int64)
    order = np.lexsort((np.arange(n), T))
    occ_pos[order] = np.arange(n) - count[T[order]]
    lf = count[T] + occ_pos  # LF target of the group leader

    is_leader = leader_of == np.arange(n)
    # ties per leader (#non-leader members pointing at it)
    ties = np.bincount(leader_of[~is_leader], minlength=n)

    link = np.where(is_leader, lf, leader_of)
    chars = T.astype(np.uint8)
    cnt_rem = ties.astype(np.int64)  # remaining tie slots per leader

    out = np.empty(n, dtype=np.uint8)
    p = index
    for i in range(n - 1, -1, -1):
        if not is_leader[p]:
            p = link[p]
        out[i] = chars[p]
        if cnt_rem[p] > 0:
            # consume one tie slot: stay on the leader, next chase starts at
            # leader's lf advanced by remaining ties
            q = link[p] + cnt_rem[p]
            cnt_rem[p] -= 1
            p = q
        else:
            p = link[p]
    data[:] = out
    return 0
