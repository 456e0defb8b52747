"""MultiModel: coupled submodels with cross-terms.

Port of the JAX package's ``multimodel/core.py``. Counterpart of the
reference multimodel layer (reference: src/multimodel/model.jl:91-616
``MultiModel``; src/multimodel/crossterm.jl:3-660 ``CrossTerm``/
``AdditiveCrossTerm``/``CTSkewSymmetry`` + ``add_cross_term!``; linear
system coupling src/linsolve/multimodel.jl).

A MultiModel is a dict of SimulationModels plus a list of cross-term pairs
with STATIC connection index arrays. Assembly gives per-model BlockELL
diagonal systems (each submodel's generic engine) plus coupling blocks:
the cross-term's local function is differentiated over the whole batch of
connections (one ``torch.func.jvp`` per dof of each side, where the JAX
package vmaps ``jax.jacfwd``) and added (a) to the target model's diagonal
blocks (w.r.t. target dofs) and (b) into COO coupling blocks (w.r.t.
source dofs). The coupled system solves as one Krylov space over the
concatenated dof vector (the reference's single-sparse-matrix path); Schur
group reduction is layered on top (linsolve/schur.py).

Every add whose destination rows repeat — a wellbore row receiving each
of its perforations, in the residual, the Jacobian's diagonal blocks and
the coupling products — goes through an ``IndexPlan`` (ops/blockell.py),
built once per connection list: the repeated entries are summed in a fixed
order and written to distinct rows, so a CUDA run repeats its bits
(``index_add_`` would add float atomics in no fixed order).

Cross terms are written over BATCHES of connections, as every model
function of the port: ``value`` gets the gathered states of all m
connections (leading axis m) and returns (m, neq).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.func import jvp

from ..models.setup import setup_parameters, setup_state
from ..ops.assembly import compile_model
from ..ops.blockell import BlockELL, IndexPlan


class CrossTerm:
    """Base cross-term (reference crossterm.jl:3).

    Subclasses implement ``value(model_t, model_s, local_t, local_s, dt)``
    -> (m, neq) for the batch of m connections; entries of ``local_t`` /
    ``local_s`` are the states gathered at the connections' target /
    source cells (leading axis m). ``symmetric`` marks CTSkewSymmetry: the
    negated value is added to the source model's same-named equation.

    A cross term may carry static per-connection data (reference
    crossterm.jl stores e.g. well-perforation WI in the struct): set
    ``self.conn_data = {name: (m, ...) array}`` and accept a sixth
    argument, ``value(..., dt, conn)``, where ``conn[name]`` is that array
    as a tensor in the states' dtype on their device.
    """

    symmetric: bool = False
    conn_data: "dict | None" = None

    def value(self, model_t, model_s, local_t, local_s, dt):
        raise NotImplementedError


class AdditiveCrossTerm(CrossTerm):
    pass


@dataclass
class CrossTermPair:
    """reference core_types.jl:1071-1085 CrossTermPair."""

    target: str
    source: str
    equation: str
    cross_term: Any
    target_cells: np.ndarray
    source_cells: np.ndarray


class MultiModel:
    """Named submodels + cross terms (reference core_types.jl:1098).
    ``groups`` (a dict name -> group or a list in model order) with
    ``reduction="schur_apply"`` makes the Simulator's default solver
    Schur-eliminate every model outside the first model's group."""

    def __init__(self, models: dict, groups=None, context=None,
                 reduction=None):
        self.models: "OrderedDict[str, Any]" = OrderedDict(models)
        self.cross_terms: list[CrossTermPair] = []
        self.groups = groups
        self.reduction = reduction

    def __getitem__(self, name: str):
        return self.models[name]

    def add_cross_term(self, cross_term, target: str, source: str,
                       equation: str, target_cells=None, source_cells=None):
        """reference add_cross_term! (multimodel/crossterm.jl)."""
        if target not in self.models or source not in self.models:
            raise KeyError(f"unknown model in ({target!r}, {source!r})")
        if equation not in self.models[target].equations:
            raise KeyError(f"{target!r} has no equation {equation!r}")
        tc = np.atleast_1d(np.asarray(
            target_cells if target_cells is not None else [0], dtype=np.int64))
        sc = np.atleast_1d(np.asarray(
            source_cells if source_cells is not None else [0], dtype=np.int64))
        if tc.shape != sc.shape:
            raise ValueError("target_cells and source_cells must align")
        self.cross_terms.append(
            CrossTermPair(target, source, equation, cross_term, tc, sc))

    # --- setup (host numpy, as the single-model functions) ------------
    def setup_state(self, **per_model) -> dict:
        return {name: per_model.get(name, setup_state(m))
                for name, m in self.models.items()}

    def setup_parameters(self, **per_model) -> dict:
        return {name: per_model.get(name, setup_parameters(m))
                for name, m in self.models.items()}

    def setup_forces(self, **per_model) -> dict:
        return {name: per_model.get(name) for name in self.models}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MultiModel({list(self.models)}, "
                f"{len(self.cross_terms)} cross-terms)")


def add_cross_term(model: MultiModel, cross_term, target: str, source: str,
                   equation: str, target_cells=None, source_cells=None):
    """Free-function form of ``MultiModel.add_cross_term`` (the
    reference's exported ``add_cross_term!``, multimodel/crossterm.jl)."""
    model.add_cross_term(cross_term, target, source, equation,
                         target_cells=target_cells,
                         source_cells=source_cells)


@dataclass
class CouplingBlock:
    """Off-diagonal COO coupling (reference LinearizedBlock,
    linsolve/default.jl:44): ``blocks[i]`` couples row ``rows.idx[i]`` of
    the target model with cell ``cols.idx[i]`` of the source model;
    ``rows``/``cols`` are the connection list's ``IndexPlan``s."""

    target: str
    source: str
    rows: IndexPlan
    cols: IndexPlan
    blocks: Any  # (m, neq_t, ndof_s)

    def product(self, x_source):
        """(m, neq_t) contributions of ``blocks @ x_source[cols]``."""
        return torch.sum(self.blocks * self.cols.gather(x_source)[:, None, :],
                         dim=-1)

    def rproduct(self, y_target):
        """(m, ndof_s) contributions of ``blocks^T @ y_target[rows]``."""
        return torch.sum(self.blocks * self.rows.gather(y_target)[:, :, None],
                         dim=1)


@dataclass(eq=False)  # identity eq/hash: one instance per compiled model
class MultiLayout:
    names: list
    dof_slices: dict  # name -> (slice into flat dof vec, (n, ndof))
    res_slices: dict  # name -> (slice into flat res vec, (n, neq))
    total_dof: int
    total_res: int


class MultiLinearizedSystem:
    """Coupled system: per-model BlockELL + coupling blocks
    (reference MultiLinearizedSystem, linsolve/default.jl:70)."""

    def __init__(self, diag: dict, couplings: list, layout: MultiLayout):
        self.diag = diag
        self.couplings = couplings
        self.layout = layout

    def matvec(self, x: dict) -> dict:
        y = {name: J.matvec(x[name]) for name, J in self.diag.items()}
        for cb in self.couplings:
            y[cb.target] = cb.rows.add(y[cb.target], cb.product(x[cb.source]))
        return y

    def rmatvec(self, y: dict) -> dict:
        """The transposed product ``J^T y`` (dict over models), every sum
        in a fixed order (``ell_rmatvec`` and the coupling ``IndexPlan``s)."""
        x = {name: J.rmatvec(y[name]) for name, J in self.diag.items()}
        for cb in self.couplings:
            x[cb.source] = cb.cols.add(x[cb.source], cb.rproduct(y[cb.target]))
        return x

    # --- flat vector interface (for Krylov / direct) -------------------
    def flatten_res(self, d: dict):
        return torch.cat([d[n].reshape(-1) for n in self.layout.names])

    flatten_dofs = flatten_res

    def _unflatten(self, v, slices) -> dict:
        return {n: v[slices[n][0]].reshape(slices[n][1])
                for n in self.layout.names}

    def unflatten_dofs(self, v) -> dict:
        return self._unflatten(v, self.layout.dof_slices)

    def unflatten_res(self, v) -> dict:
        return self._unflatten(v, self.layout.res_slices)

    def matvec_flat(self, v):
        return self.flatten_res(self.matvec(self.unflatten_dofs(v)))

    def rmatvec_flat(self, v):
        return self.flatten_dofs(self.rmatvec(self.unflatten_res(v)))

    def to_dense(self):
        """Dense (total_res, total_dof) matrix (small systems / tests);
        coupling entries that land on one position are summed in a fixed
        order."""
        lay = self.layout
        N, M = lay.total_res, lay.total_dof
        any_blocks = next(iter(self.diag.values())).blocks
        out = any_blocks.new_zeros((N, M))
        for n, J in self.diag.items():
            d = J.to_dense()
            r0 = lay.res_slices[n][0].start
            c0 = lay.dof_slices[n][0].start
            out[r0:r0 + d.shape[0], c0:c0 + d.shape[1]] = d
        pos, vals = [], []
        for cb in self.couplings:
            m, neq_t, ndof_s = cb.blocks.shape
            rr = lay.res_slices[cb.target][0].start + cb.rows.idx * neq_t
            cc = lay.dof_slices[cb.source][0].start + cb.cols.idx * ndof_s
            pos.append(((rr[:, None, None] + np.arange(neq_t)[None, :, None])
                        * M + cc[:, None, None]
                        + np.arange(ndof_s)[None, None, :]).reshape(-1))
            vals.append(cb.blocks.reshape(-1))
        if pos:
            out = IndexPlan(np.concatenate(pos)).add(
                out.reshape(-1), torch.cat(vals), inplace=True).reshape(N, M)
        return out


class _NamedEq:
    """An equation under its ``"model.eq"`` name (the tolerance lookup)."""

    def __init__(self, name, eq):
        self.name = name
        self.eq = eq


def _jac_columns(f, U):
    """(m, neq, ndof) Jacobian of ``f`` at U (m, ndof): one
    ``torch.func.jvp`` per dof over the whole batch."""
    cols = []
    for j in range(U.shape[1]):
        e = torch.zeros_like(U)
        e[:, j] = 1.0
        cols.append(jvp(f, (U,), (e,))[1])
    return torch.stack(cols, dim=-1)


class CompiledMultiModel:
    """Assembly engine for MultiModel — the interface of the compiled
    model (raw-state ``residual`` and ``assemble``, ``convergence``,
    ``apply_update``) over dicts name -> per-model value, so the Simulator
    drives both."""

    is_multi = True

    def __init__(self, mm: MultiModel):
        self.mm = mm
        self.comps = OrderedDict(
            (name, compile_model(m)) for name, m in mm.models.items())
        dof_slices, res_slices = {}, {}
        od = orr = 0
        for n, c in self.comps.items():
            nd = c.n_cells * c.ndof
            nr = c.n_cells * c.neq_total
            dof_slices[n] = (slice(od, od + nd), (c.n_cells, c.ndof))
            res_slices[n] = (slice(orr, orr + nr), (c.n_cells, c.neq_total))
            od += nd
            orr += nr
        self.layout = MultiLayout(list(self.comps), dof_slices, res_slices,
                                  od, orr)
        # equations view for the tolerance lookup: "model.eq" names
        self.equations = [_NamedEq(f"{n}.{info.name}", info.eq)
                          for n, c in self.comps.items()
                          for info in c.equations]
        # per pair: the target and source connection lists' plans, the
        # equation's row slices, the connection data per (device, dtype)
        self._pairs = [(pair, IndexPlan(pair.target_cells),
                        IndexPlan(pair.source_cells),
                        self._eq_slice(pair.target, pair.equation),
                        self._eq_slice(pair.source, pair.equation)
                        if pair.cross_term.symmetric else None, {})
                       for pair in mm.cross_terms]

    # ------------------------------------------------------------------
    def evaluate_secondaries(self, state: dict) -> dict:
        return {n: self.comps[n].evaluate_secondaries(state[n])
                for n in self.comps}

    def get_dofs(self, state: dict) -> dict:
        return {n: self.comps[n].get_dofs(state[n]) for n in self.comps}

    def apply_update(self, state: dict, du: dict, relaxation=1.0) -> dict:
        return {n: self.comps[n].apply_update(state[n], du[n], relaxation)
                for n in self.comps}

    def _eq_slice(self, model_name, eq_name):
        for info in self.comps[model_name].equations:
            if info.name == eq_name:
                return info.row_slice
        raise KeyError(eq_name)

    # ------------------------------------------------------------------
    def _local(self, name, state, plan):
        """Entries of ``state`` (a submodel's) gathered at ``plan``'s
        cells: every known entry whose leading dimension is the model's
        row count (the JAX package's filter: a one-cell well model's
        face parameters stay out)."""
        comp = self.comps[name]
        return {k: plan.gather(v) for k, v in state.items()
                if comp.cell_entry_entity.get(k) is not None
                and torch.is_tensor(v) and v.dim() >= 1
                and v.shape[0] == comp.n_cells}

    @staticmethod
    def _conn(ct, cache, like):
        """The cross term's connection data as tensors in ``like``'s dtype
        on its device, or None. The port computes cross-term values in the
        state's dtype (as it does ``dt``); the JAX package under x64
        promotes an f32 state's value to the float64 ``conn_data`` and
        casts it back as it is added."""
        cd = getattr(ct, "conn_data", None)
        if not cd:
            return None
        key = (str(like.device), like.dtype)
        if key not in cache:
            cache[key] = {k: torch.as_tensor(np.asarray(v), device=like.device,
                                             dtype=like.dtype)
                          for k, v in cd.items()}
        return cache[key]

    def _value(self, pair, lt, ls, dt, conn):
        ct, models = pair.cross_term, self.mm.models
        args = (models[pair.target], models[pair.source], lt, ls, dt)
        return ct.value(*args, conn) if conn is not None else ct.value(*args)

    def _residual_evaluated(self, full: dict, full0: dict, dt, forces=None):
        """Residuals (dict) of secondary-evaluated states."""
        forces = forces or {}
        r = {n: c._residual_evaluated(full[n], full0[n], dt, forces.get(n))
             for n, c in self.comps.items()}
        for pair, tplan, splan, sl, sl_s, cache in self._pairs:
            lt = self._local(pair.target, full[pair.target], tplan)
            ls = self._local(pair.source, full[pair.source], splan)
            like = next(iter(lt.values()))
            vals = self._value(pair, lt, ls, dt,
                               self._conn(pair.cross_term, cache, like))
            r[pair.target] = tplan.add(r[pair.target], vals, sl)
            if sl_s is not None:
                r[pair.source] = splan.add(r[pair.source], -vals, sl_s)
        return r

    def residual(self, state: dict, state0: dict, dt, forces=None):
        """Residuals (dict name -> (n, neq)) of raw states (secondaries
        are evaluated here), the single-model engines' contract."""
        return self._residual_evaluated(self.evaluate_secondaries(state),
                                        self.evaluate_secondaries(state0),
                                        dt, forces)

    def assemble(self, state: dict, state0: dict, dt, forces=None,
                 with_jacobian: bool = True):
        """(residual dict, MultiLinearizedSystem, secondary-evaluated
        states)."""
        full = self.evaluate_secondaries(state)
        full0 = self.evaluate_secondaries(state0)
        r = self._residual_evaluated(full, full0, dt, forces)
        if not with_jacobian:
            return r, None, full
        forces = forces or {}
        diag = {n: BlockELL(c.ell, c.jacobian_blocks(full[n], full0[n], dt,
                                                     forces.get(n)))
                for n, c in self.comps.items()}
        couplings = []
        for entry in self._pairs:
            couplings.extend(self._cross_term_jacobian(entry, full, dt, diag))
        return r, MultiLinearizedSystem(diag, couplings, self.layout), full

    def _cross_term_jacobian(self, entry, full, dt, diag):
        """Both sides' Jacobians of the cross term over its connections:
        d value / d u_target onto the target's diagonal blocks, d value /
        d u_source as a coupling block (and, skew-symmetric, the negated
        pair for the source's rows). ``diag``'s blocks are updated in
        place (fresh tensors of this assembly)."""
        pair, tplan, splan, sl, sl_s, cache = entry
        t, s = pair.target, pair.source
        ct_c, cs_c = self.comps[t], self.comps[s]
        prim_t, prim_s = ct_c.model.primary_variables, \
            cs_c.model.primary_variables
        U_t = ct_c.get_dofs({k: tplan.gather(full[t][k]) for k in prim_t})
        U_s = cs_c.get_dofs({k: splan.gather(full[s][k]) for k in prim_s})
        p_t = {k: tplan.gather(v) for k, v in ct_c._cell_entries(
            full[t], include=("parameter",)).items()}
        p_s = {k: splan.gather(v) for k, v in cs_c._cell_entries(
            full[s], include=("parameter",)).items()}
        conn = self._conn(pair.cross_term, cache, U_t)

        def local(u_t, u_s):
            lt = dict(p_t)
            lt.update(ct_c.unpack_dofs(u_t))
            ls = dict(p_s)
            ls.update(cs_c.unpack_dofs(u_s))
            return self._value(pair, ct_c._eval_secondaries_local(lt),
                               cs_c._eval_secondaries_local(ls), dt, conn)

        jac_t = _jac_columns(lambda u: local(u, U_s), U_t)  # (m, neq, ndof_t)
        jac_s = _jac_columns(lambda u: local(U_t, u), U_s)  # (m, neq, ndof_s)
        tplan.add(diag[t].blocks, jac_t, 0, sl, inplace=True)
        cbs = [CouplingBlock(t, s, tplan, splan, jac_s)]
        if sl_s is not None:
            splan.add(diag[s].blocks, -jac_s, 0, sl_s, inplace=True)
            cbs.append(CouplingBlock(s, t, splan, tplan, -jac_t))
        return cbs

    def convergence(self, r: dict, full: dict, dt) -> dict:
        return {f"{n}.{eq}": crits
                for n, c in self.comps.items()
                for eq, crits in c.convergence(r[n], full[n], dt).items()}


def compile_multi_model(mm: MultiModel) -> CompiledMultiModel:
    return CompiledMultiModel(mm)
