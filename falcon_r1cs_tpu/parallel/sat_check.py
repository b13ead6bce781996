"""Device satisfiability checking: (A.w) o (B.w) - C.w == 0 as tensor ops.

The device replacement for arkworks' `cs.is_satisfied()` (SURVEY.md
section 7 step 3) and itself a benchmark kernel.

Design: 255-bit field arithmetic is hostile to int32 device lanes, but every
constraint row of these circuits except the tagged `field_rows` holds
EXACTLY over the signed integers (see r1cs/coo.py), with
|A.w| * |B.w| provably below 2^330 (conservative bound: <= nnz_row *
2^146(coeff) * 2^164(witness)).  So satisfiability is checked by CRT:

    for enough 15-bit primes m_k that prod m_k > 2^331:
        (A.w)(B.w) - C.w  ==  0  (mod m_k)      -- all in int32 lanes

Products of 15-bit residues stay below 2^30; per-element mod after each
product keeps segment sums below 2^25 * 2^15.  The tagged field rows (the
is_eq multiplier rows, O(n) of them with 2-term LCs) are checked in exact
host arithmetic.

Batched over signatures: the witness residue tensor is (P, B, W) int32,
sharded over a ("batch",) mesh axis; each prime's sparse matvec is a
gather + segment_sum, vectorized over B.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..r1cs.coo import CompiledR1CS

# 15-bit primes, largest first; 24 of them give prod > 2^359 >> the 2^330
# row bound, so the CRT check is exact, not probabilistic.
_NUM_PRIMES = 24


@functools.lru_cache(maxsize=None)
def _crt_kernel(num_constraints: int, num_primes: int):
    """jit-compiled CRT satisfiability kernel, shared across systems with the
    same shape.  Tables are passed as runtime args (not baked constants) so
    XLA does not constant-fold multi-MB gathers at compile time."""

    @jax.jit
    def run(w, tables):
        primes = tables["primes"]
        mask = tables["mask"]

        def one_prime(k):
            m = primes[k]

            def matvec(rows, cols, vals):
                # (B, nnz): residue products reduced before summing
                prod = (vals[k][None, :] * w[k][:, cols]) % m
                return jax.ops.segment_sum(
                    prod.T, rows, num_segments=num_constraints
                ).T % m  # (B, nc)

            aw = matvec(*tables["a"])
            bw = matvec(*tables["b"])
            cw = matvec(*tables["c"])
            bad = (aw * bw - cw) % m != 0
            return jnp.any(bad & mask[None, :], axis=1)  # (B,)

        # one prime at a time: a vmap over the primes holds every prime's
        # (B, nnz) product at once — 71 GiB for 256 Falcon-1024 witnesses
        fails = jax.lax.map(one_prime, jnp.arange(num_primes))
        return ~jnp.any(fails, axis=0)

    return run


@functools.lru_cache(maxsize=None)
def crt_primes(count: int = _NUM_PRIMES) -> tuple[int, ...]:
    primes = []
    x = (1 << 15) - 1
    while len(primes) < count and x > 2:
        for d in range(2, int(x**0.5) + 1):
            if x % d == 0:
                break
        else:
            primes.append(x)
        x -= 2
    return tuple(primes)


class ResidueSystem:
    """Host-precomputed residue form of a CompiledR1CS."""

    def __init__(self, compiled: CompiledR1CS, primes=None):
        self.compiled = compiled
        if primes is None:
            from ..utils.config import get_config

            primes = crt_primes(get_config().num_crt_primes)
        self.primes = np.asarray(primes, dtype=np.int32)
        P = len(self.primes)

        def residues(which):
            # cached limb form (persisted in the artifact), then vectorized
            # per-prime mods
            signs, limbs = compiled.vals_limbs(which)
            out = np.empty((P, limbs.shape[0]), dtype=np.int32)
            for k, m in enumerate(self.primes):
                out[k] = CompiledR1CS.limb_residues(signs, limbs, int(m))
            return out

        self.a_rows, self.a_cols, _ = compiled.a
        self.b_rows, self.b_cols, _ = compiled.b
        self.c_rows, self.c_cols, _ = compiled.c
        self.a_res = residues("a")
        self.b_res = residues("b")
        self.c_res = residues("c")
        # mask excluding field rows from the integer check
        mask = np.ones(compiled.num_constraints, dtype=bool)
        mask[compiled.field_rows] = False
        self.int_row_mask = mask

    def witness_residues(self, assignments: np.ndarray) -> np.ndarray:
        """(B, V) object ints -> (P, B, V) int32 residues.

        Integer-path witnesses are < 2^164 nonnegative; field-sized values
        (is_eq multipliers) are reduced mod p implicitly by % m of their
        mod-p representative -- harmless, as field rows are excluded."""
        P = len(self.primes)
        B, V = assignments.shape
        signs, limbs = CompiledR1CS.signed_to_limbs(assignments.reshape(-1))
        out = np.empty((P, B, V), dtype=np.int32)
        for k, m in enumerate(self.primes):
            out[k] = (
                CompiledR1CS.limb_residues(signs, limbs, int(m))
                .reshape(B, V)
                .astype(np.int32)
            )
        return out

    def witness_residues_from_packed(
        self, instance: np.ndarray, packed
    ) -> np.ndarray:
        """Residues from the DEVICE-PACKED witness (B, W, <=8 u32 limbs) +
        (B, I) small instance values -- no Python big-int pass at all."""
        P = len(self.primes)
        packed = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
        instance = np.asarray(instance, dtype=np.int64)
        B, W, L = packed.shape
        V = instance.shape[1] + W
        out = np.empty((P, B, V), dtype=np.int32)
        for k, m in enumerate(self.primes):
            m = int(m)
            weights = np.array(
                [pow(2, 32 * j, m) for j in range(L)], dtype=np.int64
            )
            wit = ((packed % m) @ weights) % m
            out[k, :, : instance.shape[1]] = instance % m
            out[k, :, instance.shape[1] :] = wit
        return out

    @functools.cached_property
    def _device_tables(self):
        return dict(
            primes=jnp.asarray(self.primes),
            mask=jnp.asarray(self.int_row_mask),
            a=(jnp.asarray(self.a_rows), jnp.asarray(self.a_cols),
               jnp.asarray(self.a_res)),
            b=(jnp.asarray(self.b_rows), jnp.asarray(self.b_cols),
               jnp.asarray(self.b_res)),
            c=(jnp.asarray(self.c_rows), jnp.asarray(self.c_cols),
               jnp.asarray(self.c_res)),
        )

    def check_device(self, w_res) -> np.ndarray:
        """Run the CRT check on device.  w_res: (P, B, V) int32.
        Returns (B,) bool: True = all integer rows satisfied."""
        nc = self.compiled.num_constraints
        run = _crt_kernel(nc, len(self.primes))
        return np.asarray(run(jnp.asarray(w_res), self._device_tables))

    def check_device_sharded(self, w_res, mesh, axis: str = "batch"):
        """Row-range-sharded CRT check over a device mesh (SURVEY.md
        section 2.4: COO sharded by constraint-row ranges).

        The COO triples are partitioned into D contiguous nnz ranges
        (padded to equal length with no-op entries pointing at a dummy
        row); each device evaluates its own rows' residual for every prime
        and the verdicts are AND-reduced.  The witness residues are
        replicated (they are small compared to the matrices).
        Returns (B,) bool.
        """
        import jax
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        D = mesh.shape[axis]
        nc = self.compiled.num_constraints
        nc_pad = nc + 1  # last row = padding sink, always satisfied

        # common ROW boundaries for A, B, C (a row's entries must land on
        # one device so its residual is complete), balanced by A-nnz
        row_bounds = [0]
        for d in range(1, D):
            if len(self.a_rows):
                row_bounds.append(
                    int(self.a_rows[len(self.a_rows) * d // D])
                )
            else:
                row_bounds.append(nc * d // D)
        row_bounds.append(nc)
        # boundaries must be non-decreasing and start at row 0 so every
        # constraint's A, B, AND C entries land on exactly one device
        for d in range(1, len(row_bounds)):
            row_bounds[d] = max(row_bounds[d], row_bounds[d - 1])

        def shard_coo(rows, cols, res):
            splits = [
                np.nonzero(
                    (rows >= row_bounds[d]) & (rows < row_bounds[d + 1])
                )[0]
                for d in range(D)
            ]
            max_len = max(max(len(s) for s in splits), 1)
            r_out = np.full((D, max_len), nc, dtype=np.int32)  # pad row
            c_out = np.zeros((D, max_len), dtype=np.int32)
            v_out = np.zeros((D, len(self.primes), max_len), dtype=np.int32)
            for d, s in enumerate(splits):
                r_out[d, : len(s)] = rows[s]
                c_out[d, : len(s)] = cols[s]
                v_out[d, :, : len(s)] = res[:, s]
            return r_out, c_out, v_out

        a_sh = shard_coo(self.a_rows, self.a_cols, self.a_res)
        b_sh = shard_coo(self.b_rows, self.b_cols, self.b_res)
        c_sh = shard_coo(self.c_rows, self.c_cols, self.c_res)
        primes = jnp.asarray(self.primes)
        mask = jnp.asarray(
            np.concatenate([self.int_row_mask, [False]])
        )

        def local(w, ar, ac, av, br, bc, bv, cr, cc, cv):
            # shard_map gives each device its (1, ...) slice; drop it
            ar, ac, av = ar[0], ac[0], av[0]
            br, bc, bv = br[0], bc[0], bv[0]
            cr, cc, cv = cr[0], cc[0], cv[0]

            def one_prime(k):
                m = primes[k]

                def matvec(rows, cols, vals):
                    prod = (vals[k][None, :] * w[k][:, cols]) % m
                    return jax.ops.segment_sum(
                        prod.T, rows, num_segments=nc_pad
                    ).T % m

                aw = matvec(ar, ac, av)
                bw = matvec(br, bc, bv)
                cw = matvec(cr, cc, cv)
                bad = (aw * bw - cw) % m != 0
                return jnp.any(bad & mask[None, :], axis=1)

            fails = jax.lax.map(one_prime, jnp.arange(len(self.primes)))
            any_fail = jnp.any(fails, axis=0)          # (B,)
            return jax.lax.pmax(any_fail.astype(jnp.int32), axis)

        fn = shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(),  # witness residues replicated
                P(axis), P(axis), P(axis),
                P(axis), P(axis), P(axis),
                P(axis), P(axis), P(axis),
            ),
            out_specs=P(),
        )
        out = jax.jit(fn)(
            jnp.asarray(w_res), *map(jnp.asarray, a_sh),
            *map(jnp.asarray, b_sh), *map(jnp.asarray, c_sh)
        )
        return ~np.asarray(out).astype(bool)

    def check_field_rows_host(self, assignment: list[int]) -> bool:
        """Exact mod-p evaluation of the few tagged field rows."""
        comp = self.compiled
        p = comp.p
        rows_needed = set(int(r) for r in comp.field_rows)
        if not rows_needed:
            return True

        def row_vals(mat):
            rows, cols, vals = mat
            acc = {r: 0 for r in rows_needed}
            for r, c, v in zip(rows, cols, vals):
                r = int(r)
                if r in acc:
                    acc[r] += int(v) * assignment[c]
            return acc

        a = row_vals(comp.a)
        b = row_vals(comp.b)
        c = row_vals(comp.c)
        return all(
            (a[r] % p) * (b[r] % p) % p == c[r] % p for r in rows_needed
        )

    def is_satisfied(self, assignments: np.ndarray) -> np.ndarray:
        """Full batched check: device CRT for integer rows + host field
        rows.  assignments: (B, V) object ints.  Returns (B,) bool."""
        ok = np.array(self.check_device(self.witness_residues(assignments)))
        for b in range(assignments.shape[0]):
            if ok[b] and len(self.compiled.field_rows):
                ok[b] = self.check_field_rows_host(list(assignments[b]))
        return ok
