"""Union-find inputs shared by the CPU tests (the port's plain union-find
against the JAX package's) and the card tests (the kernels against the plain
versions).  numpy only, so the card tests, which import no JAX, can use them.

Each case is (parent, u, v): an int32 parent forest and int64 edge ends."""

import numpy as np


def random_forest(rng, n: int, linked: float = 0.6, chains: int = 3) -> np.ndarray:
    """An uncompressed forest over n slots whose roots are not minima: each
    of a share of the slots is linked to a random slot of another tree (to
    that slot itself, not its root, so trees grow deep), and `chains` runs of
    slots are hooked as chains pointing upwards (parent[i] = i + 1)."""
    parent = np.arange(n, dtype=np.int32)

    def root(x):
        while parent[x] != x:
            x = parent[x]
        return x

    for _ in range(chains):
        a = int(rng.integers(0, max(1, n - 8)))
        for i in range(a, min(n - 1, a + 8)):
            if root(i + 1) != i and root(i) == i:
                parent[i] = i + 1
    for x in rng.permutation(n)[: int(n * linked)]:
        y = int(rng.integers(0, n))
        if root(x) == x and root(y) != x:
            parent[x] = y
    return parent


def _identity(n):
    return np.arange(n, dtype=np.int32)


def uf_cases() -> dict:
    """name -> (parent int32 [n], u int64 [m], v int64 [m])."""
    rng = np.random.default_rng(2024)
    cases = {}
    n = 300
    parent = random_forest(rng, n)
    cases["forest"] = (parent, rng.integers(0, n, 120), rng.integers(0, n, 120))
    small = _identity(8)
    small[0] = 1  # parent[0] = 1: a root that is not its component's minimum
    cases["root_not_min"] = (small, np.array([0, 5, 6]), np.array([7, 6, 1]))
    u = rng.integers(0, n, 200)
    v = rng.integers(0, n, 200)
    loops = rng.integers(0, n, 50)
    dup = rng.integers(0, 200, 150)
    cases["self_loops_duplicates"] = (_identity(n), np.concatenate([u, loops, u[dup], v[dup]]),
                                      np.concatenate([v, loops, v[dup], u[dup]]))
    n_chain = 3000
    k = np.arange(n_chain - 2, -1, -1)
    cases["reverse_chain"] = (_identity(n_chain), k + 1, k)
    n_star = 1000
    leaves = rng.permutation(np.delete(np.arange(n_star), n_star // 2))
    cases["star"] = (_identity(n_star), np.full(leaves.size, n_star // 2), leaves)
    # the pipeline's F/R pre-unite, then match runs in both orientations
    L = 400
    i = np.arange(L)
    runs_u = [i << 1]
    runs_v = [(i << 1) | 1]
    for _ in range(12):
        ln = int(rng.integers(5, 60))
        a, b = rng.integers(0, L - ln, 2)
        j = np.arange(ln)
        runs_u.append((a + j) << 1)
        runs_v.append(((L - 1 - (b + j)) << 1) | 1 if rng.integers(0, 2) else (b + j) << 1)
    cases["runs"] = (_identity(2 * L + 2), np.concatenate(runs_u), np.concatenate(runs_v))
    cases["empty"] = (random_forest(rng, 50), np.zeros(0, np.int64), np.zeros(0, np.int64))
    # one edge as reversed views (negative strides; numpy calls them contiguous)
    cases["reversed_views"] = (_identity(6), np.array([4, 2])[::-2], np.array([0, 5])[::-2])
    return cases


def pre_unite_edges(total_length: int):
    """The pipeline's F/R pre-unite of every offset."""
    i = np.arange(total_length, dtype=np.int64)
    return i << 1, (i << 1) | 1
