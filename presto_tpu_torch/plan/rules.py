"""Iterative rule-based plan optimizer + channel pruning.

The port's copy of presto_tpu/plan/rules.py (Presto's
IterativeOptimizer and its PruneUnreferencedOutputs family), two
shapes:

  * `IterativeOptimizer`: bottom-up fixpoint application of local
    rewrite rules declared with the `plan.matching` DSL
    (MergeAdjacentFilters, PushFilterThroughProject, InlineProjections,
    RemoveIdentityProject, MergeLimits, PushLimitThroughProject,
    LimitOverSortToTopN).
  * `prune_unreferenced`: one top-down channel-requirement pass that
    narrows projections, scans, join outputs, aggregates, and window
    functions to what the consumer actually reads (a single pass is
    enough on this IR because symbols are already channels).

`optimize_plan` runs both, then folds constant expressions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import types as T
from ..expr import ir as E
from ..expr.logical import (and_all, conjuncts, input_channels,
                            map_input_channels)
from . import nodes as N
from .matching import Pattern, node

__all__ = ["Rule", "IterativeOptimizer", "DEFAULT_RULES",
           "prune_unreferenced", "optimize_plan"]


# ---------------------------------------------------------------------------
# Rule machinery
# ---------------------------------------------------------------------------

class Rule:
    """One local rewrite: `pattern` guards, `apply` returns a
    replacement node or None (no-op). Mirrors iterative.Rule."""
    pattern: Pattern = node()

    def apply(self, n: N.PlanNode) -> Optional[N.PlanNode]:
        raise NotImplementedError


class IterativeOptimizer:
    """Bottom-up fixpoint driver (IterativeOptimizer analog; the memo/
    group machinery collapses away because rules here rewrite in place
    on an immutable-enough dataclass tree)."""

    def __init__(self, rules: Sequence[Rule], max_iterations: int = 100):
        self.rules = list(rules)
        self.max_iterations = max_iterations

    def optimize(self, root: N.PlanNode) -> N.PlanNode:
        for _ in range(self.max_iterations):
            new_root, changed = self._rewrite(root)
            if not changed:
                return new_root
            root = new_root
        return root

    def _rewrite(self, n: N.PlanNode) -> Tuple[N.PlanNode, bool]:
        changed = False
        # children first
        new_srcs = []
        for s in n.sources:
            ns, ch = self._rewrite(s)
            new_srcs.append(ns)
            changed |= ch
        if changed:
            n = _replace_sources(n, new_srcs)
        for rule in self.rules:
            if rule.pattern.match(n) is None:
                continue
            out = rule.apply(n)
            if out is not None and out is not n:
                return out, True
        return n, changed


def _replace_sources(n: N.PlanNode, new_sources: List[N.PlanNode]
                     ) -> N.PlanNode:
    if isinstance(n, N.JoinNode):
        return dataclasses.replace(n, left=new_sources[0],
                                   right=new_sources[1])
    if isinstance(n, N.SemiJoinNode):
        return dataclasses.replace(n, source=new_sources[0],
                                   filtering_source=new_sources[1])
    if isinstance(n, N.UnionNode):
        return dataclasses.replace(n, inputs=list(new_sources))
    if not new_sources:
        return n
    return dataclasses.replace(n, source=new_sources[0])


# ---------------------------------------------------------------------------
# Core simplification rules
# ---------------------------------------------------------------------------

class MergeAdjacentFilters(Rule):
    """Filter(Filter(s, p2), p1) -> Filter(s, p2 AND p1)
    (iterative/rule/MergeFilters analog)."""
    pattern = node(N.FilterNode).with_source(node(N.FilterNode))

    def apply(self, n):
        inner = n.source
        return N.FilterNode(inner.source,
                            and_all(conjuncts(inner.predicate)
                                    + conjuncts(n.predicate)))


class RemoveTrueFilter(Rule):
    """Filter(s, TRUE) -> s."""
    pattern = node(N.FilterNode).matching(
        lambda n: isinstance(n.predicate, E.Constant)
        and n.predicate.value is True)

    def apply(self, n):
        return n.source


def _inlinable(project: N.ProjectNode, used: Set[int]) -> bool:
    """Safe to substitute project expressions into a consumer: every
    used expression is a bare input/constant (never duplicates work)."""
    return all(isinstance(project.expressions[c],
                          (E.InputReference, E.Constant))
               for c in used)


class PushFilterThroughProject(Rule):
    """Filter(Project(s, es), p) -> Project(Filter(s, p'), es) where p'
    inlines the (cheap) project expressions
    (iterative/rule/PushDownFilterThroughProject analog). Only fires
    when every predicate-referenced projection is a bare ref/constant,
    so predicates migrate toward scans through renaming projections."""
    pattern = node(N.FilterNode).with_source(node(N.ProjectNode))

    def apply(self, n):
        proj: N.ProjectNode = n.source
        used = input_channels(n.predicate)
        if not _inlinable(proj, used):
            return None

        def sub(x):
            if isinstance(x, E.InputReference):
                return proj.expressions[x.channel]
            return x
        from ..expr.logical import rewrite_bottom_up
        pred = rewrite_bottom_up(n.predicate, sub)
        return N.ProjectNode(N.FilterNode(proj.source, pred),
                             proj.expressions)


class InlineProjections(Rule):
    """Project(Project(s, inner), outer) -> Project(s, outer') when the
    inner expressions the outer one references are bare refs/constants
    (iterative/rule/InlineProjections analog)."""
    pattern = node(N.ProjectNode).with_source(node(N.ProjectNode))

    def apply(self, n):
        inner: N.ProjectNode = n.source
        used = set()
        for e in n.expressions:
            used |= input_channels(e)
        if not _inlinable(inner, used):
            return None
        from ..expr.logical import rewrite_bottom_up

        def sub(x):
            if isinstance(x, E.InputReference):
                return inner.expressions[x.channel]
            return x
        return N.ProjectNode(inner.source,
                             [rewrite_bottom_up(e, sub)
                              for e in n.expressions])


def _is_identity(p: N.ProjectNode) -> bool:
    src_types = p.source.output_types()
    if len(p.expressions) != len(src_types):
        return False
    return all(isinstance(e, E.InputReference) and e.channel == i
               for i, e in enumerate(p.expressions))


class RemoveIdentityProject(Rule):
    """Project that reproduces its input verbatim -> source
    (RemoveRedundantIdentityProjections analog)."""
    pattern = node(N.ProjectNode).matching(_is_identity)

    def apply(self, n):
        return n.source


class MergeLimits(Rule):
    """Limit(Limit(s, b), a) -> Limit(s, min(a, b))."""
    pattern = node(N.LimitNode).with_source(node(N.LimitNode))

    def apply(self, n):
        return N.LimitNode(n.source.source, min(n.count, n.source.count))


class PushLimitThroughProject(Rule):
    """Limit(Project(s), k) -> Project(Limit(s, k))
    (iterative/rule/PushLimitThroughProject analog) — moves the row cut
    below projection work."""
    pattern = node(N.LimitNode).with_source(node(N.ProjectNode))

    def apply(self, n):
        proj = n.source
        return N.ProjectNode(N.LimitNode(proj.source, n.count),
                             proj.expressions)


class LimitOverSortToTopN(Rule):
    """Limit(Sort(s, keys), k) -> TopN(s, keys, k)
    (MergeLimitWithSort analog). The SQL planner emits TopN directly;
    this catches composed/ingested plans."""
    pattern = node(N.LimitNode).with_source(node(N.SortNode))

    def apply(self, n):
        srt = n.source
        return N.TopNNode(srt.source, list(srt.keys), n.count)


DEFAULT_RULES: List[Rule] = [
    MergeAdjacentFilters(), RemoveTrueFilter(), PushFilterThroughProject(),
    InlineProjections(), RemoveIdentityProject(), MergeLimits(),
    PushLimitThroughProject(), LimitOverSortToTopN(),
]


# ---------------------------------------------------------------------------
# Channel pruning (PruneUnreferencedOutputs family)
# ---------------------------------------------------------------------------

def prune_unreferenced(root: N.PlanNode) -> N.PlanNode:
    """Narrow every node's output to the channels its consumer reads.
    Returns an equivalent plan; the root's own output layout is
    preserved exactly."""
    n_out = len(root.output_types())
    new_root, mapping = _prune(root, set(range(n_out)))
    assert all(mapping[i] == i for i in range(n_out)), \
        "root layout must be stable"
    return new_root


def _ident(n: int) -> Dict[int, int]:
    return {i: i for i in range(n)}


def _prune(nd: N.PlanNode, needed: Set[int]
           ) -> Tuple[N.PlanNode, Dict[int, int]]:
    """Returns (new_node, old->new channel mapping covering `needed`,
    possibly more)."""
    width = len(nd.output_types())
    needed = {c for c in needed if c < width}

    if isinstance(nd, N.OutputNode):
        src, m = _prune(nd.source, set(range(width)))
        assert all(m[i] == i for i in range(width))
        return dataclasses.replace(nd, source=src), _ident(width)

    if isinstance(nd, N.TableScanNode):
        keep = sorted(needed) or [0]  # keep >=1 column for row counts
        if len(keep) == len(nd.columns):
            return nd, _ident(width)
        return (dataclasses.replace(
            nd, columns=[nd.columns[c] for c in keep],
            column_types=[nd.column_types[c] for c in keep]),
            {c: i for i, c in enumerate(keep)})

    if isinstance(nd, N.ValuesNode):
        # a zero-column VALUES (the FROM-less SELECT dual row) stays
        # zero-column; it still carries the row count
        keep = sorted(needed) or ([0] if nd.types else [])
        if len(keep) == len(nd.types):
            return nd, _ident(width)
        return (dataclasses.replace(
            nd, types=[nd.types[c] for c in keep],
            rows=[[r[c] for c in keep] for r in nd.rows]),
            {c: i for i, c in enumerate(keep)})

    if isinstance(nd, N.ProjectNode):
        # a zero-width projection (count(*) plans) stays zero-width;
        # otherwise keep >=1 expression as the row-count carrier
        keep = sorted(needed) or ([0] if nd.expressions else [])
        exprs = [nd.expressions[c] for c in keep]
        need_src: Set[int] = set()
        for e in exprs:
            need_src |= input_channels(e)
        if not need_src:
            # all-constant projection still needs the row count
            need_src = {0}
        src, m = _prune(nd.source, need_src)
        exprs = [map_input_channels(e, m) for e in exprs]
        return (N.ProjectNode(src, exprs, id=nd.id),
                {c: i for i, c in enumerate(keep)})

    if isinstance(nd, N.FilterNode):
        need_src = needed | input_channels(nd.predicate)
        src, m = _prune(nd.source, need_src)
        return (N.FilterNode(src, map_input_channels(nd.predicate, m),
                             id=nd.id), m)

    if isinstance(nd, (N.LimitNode, N.SampleNode)):
        src, m = _prune(nd.source, needed)
        return dataclasses.replace(nd, source=src), m

    if isinstance(nd, (N.SortNode, N.TopNNode)):
        need_src = needed | {k[0] for k in nd.keys}
        src, m = _prune(nd.source, need_src)
        keys = [(m[c], d, nl) for c, d, nl in nd.keys]
        return dataclasses.replace(nd, source=src, keys=keys), m

    if isinstance(nd, N.DistinctNode):
        kc = nd.key_channels
        if kc is None:  # DISTINCT over the full row: everything is a key
            src, m = _prune(nd.source, set(range(width)))
            return dataclasses.replace(nd, source=src), m
        src, m = _prune(nd.source, needed | set(kc))
        return (dataclasses.replace(nd, source=src,
                                    key_channels=[m[c] for c in kc]), m)

    if isinstance(nd, N.ExchangeNode):
        need_src = needed | set(nd.partition_channels)
        if nd.sort_keys:
            need_src |= {k[0] for k in nd.sort_keys}
        src, m = _prune(nd.source, need_src)
        return (dataclasses.replace(
            nd, source=src,
            partition_channels=[m[c] for c in nd.partition_channels],
            sort_keys=[(m[c], d, nl) for c, d, nl in nd.sort_keys]
            if nd.sort_keys else nd.sort_keys), m)

    if isinstance(nd, N.AggregationNode) and nd.step == "SINGLE":
        nk = len(nd.group_channels)
        keep_aggs = [i for i in range(len(nd.aggregates))
                     if (nk + i) in needed]
        # a keyless aggregation's single row IS its aggregates: keep one
        if nk == 0 and nd.aggregates and not keep_aggs:
            keep_aggs = [0]
        need_src: Set[int] = set(nd.group_channels)
        for i in keep_aggs:
            a = nd.aggregates[i]
            if a.input_channel is not None:
                need_src.add(a.input_channel)
            if a.second_channel is not None:
                need_src.add(a.second_channel)
            if a.mask_channel is not None:
                need_src.add(a.mask_channel)
        if not need_src:
            need_src = {0}
        src, m = _prune(nd.source, need_src)
        aggs = []
        for i in keep_aggs:
            a = nd.aggregates[i]
            aggs.append(dataclasses.replace(
                a,
                input_channel=None if a.input_channel is None
                else m[a.input_channel],
                second_channel=None if a.second_channel is None
                else m[a.second_channel],
                mask_channel=None if a.mask_channel is None
                else m[a.mask_channel]))
        new = dataclasses.replace(
            nd, source=src, group_channels=[m[c] for c in nd.group_channels],
            aggregates=aggs)
        mapping = {i: i for i in range(nk)}
        for pos, i in enumerate(keep_aggs):
            mapping[nk + i] = nk + pos
        return new, mapping

    if isinstance(nd, N.JoinNode):
        lt = len(nd.left.output_types())
        rsel = nd.right_output_channels
        if rsel is None:
            rsel = list(range(len(nd.right.output_types())))
        need_left = {c for c in needed if c < lt} | set(nd.left_keys)
        keep_right_pos = sorted(c - lt for c in needed if c >= lt)
        need_right = {rsel[p] for p in keep_right_pos} | set(nd.right_keys)
        left, ml = _prune(nd.left, need_left)
        right, mr = _prune(nd.right, need_right)
        new_lt = len(left.output_types())
        new = dataclasses.replace(
            nd, left=left, right=right,
            left_keys=[ml[c] for c in nd.left_keys],
            right_keys=[mr[c] for c in nd.right_keys],
            right_output_channels=[mr[rsel[p]] for p in keep_right_pos])
        # join output = full (pruned) left width ++ selected right
        mapping = {old: new_pos for old, new_pos in ml.items() if old < lt}
        for i, p in enumerate(keep_right_pos):
            mapping[lt + p] = new_lt + i
        return new, mapping

    if isinstance(nd, N.SemiJoinNode):
        sk = nd.source_key if isinstance(nd.source_key, list) \
            else [nd.source_key]
        fk = nd.filtering_key if isinstance(nd.filtering_key, list) \
            else [nd.filtering_key]
        src_w = width - 1  # output = source channels + match flag
        need_src = {c for c in needed if c < src_w} | set(sk)
        src, m = _prune(nd.source, need_src)
        filt, mf = _prune(nd.filtering_source, set(fk))
        new_sk = [m[c] for c in sk]
        new_fk = [mf[c] for c in fk]
        new = dataclasses.replace(
            nd, source=src, filtering_source=filt,
            source_key=new_sk if isinstance(nd.source_key, list)
            else new_sk[0],
            filtering_key=new_fk if isinstance(nd.filtering_key, list)
            else new_fk[0])
        mapping = {old: pos for old, pos in m.items() if old < src_w}
        mapping[src_w] = len(src.output_types())
        return new, mapping

    if isinstance(nd, N.WindowNode):
        src_w = width - len(nd.functions)
        keep_fns = [i for i in range(len(nd.functions))
                    if (src_w + i) in needed]
        need_src = {c for c in needed if c < src_w}
        need_src |= set(nd.partition_channels)
        need_src |= {k[0] for k in nd.order_keys}
        for i in keep_fns:
            ch = nd.functions[i][1]
            if ch is not None:
                need_src.add(ch)
        if not need_src:
            need_src = {0}
        src, m = _prune(nd.source, need_src)
        fns = []
        for i in keep_fns:
            name, ch, ty, frame, k = nd.functions[i]
            fns.append((name, None if ch is None else m[ch], ty, frame, k))
        new_src_w = len(src.output_types())
        new = dataclasses.replace(
            nd, source=src,
            partition_channels=[m[c] for c in nd.partition_channels],
            order_keys=[(m[c], d, nl) for c, d, nl in nd.order_keys],
            functions=fns)
        mapping = {old: pos for old, pos in m.items() if old < src_w}
        for pos, i in enumerate(keep_fns):
            mapping[src_w + i] = new_src_w + pos
        return new, mapping

    if isinstance(nd, N.UnionNode):
        keep = sorted(needed) or [0]
        target = {c: i for i, c in enumerate(keep)}
        new_inputs = []
        for inp in nd.inputs:
            child, m = _prune(inp, set(keep))
            if [m[c] for c in keep] != list(range(len(keep))) or \
                    len(child.output_types()) != len(keep):
                # normalize this child to the target layout
                tys = child.output_types()
                child = N.ProjectNode(child, [
                    E.input_ref(m[c], tys[m[c]]) for c in keep])
            new_inputs.append(child)
        return dataclasses.replace(nd, inputs=new_inputs), target

    # fallback (appended-column and not-yet-modeled kinds): keep the
    # node intact, require everything from each source, prune deeper
    new_srcs = []
    for s in nd.sources:
        ns, m = _prune(s, set(range(len(s.output_types()))))
        assert all(m[i] == i for i in range(len(s.output_types())))
        new_srcs.append(ns)
    if new_srcs:
        nd = _replace_sources(nd, new_srcs)
    return nd, _ident(width)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def fold_plan_constants(root: N.PlanNode) -> N.PlanNode:
    """Constant-fold every expression in the plan (the sidecar
    expression-optimization seam; identity-memoized for CTE DAGs)."""
    from ..expr.logical import fold_constants
    memo: dict = {}

    def walk(n: N.PlanNode) -> N.PlanNode:
        if id(n) in memo:
            return memo[id(n)]
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, N.PlanNode):
                w = walk(v)
                if w is not v:
                    changes[f.name] = w
            elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
                w = [walk(x) for x in v]
                if any(a is not b for a, b in zip(w, v)):
                    changes[f.name] = w
        if isinstance(n, N.FilterNode):
            p = fold_constants(n.predicate)
            if p is not n.predicate:
                changes["predicate"] = p
        elif isinstance(n, N.ProjectNode):
            ex = [fold_constants(e) for e in n.expressions]
            if any(a is not b for a, b in zip(ex, n.expressions)):
                changes["expressions"] = ex
        out = dataclasses.replace(n, **changes) if changes else n
        memo[id(n)] = out
        return out

    return walk(root)


def optimize_plan(root: N.PlanNode, rules: Sequence[Rule] = None,
                  prune: bool = True) -> N.PlanNode:
    """The PlanOptimizers pipeline analog for logical (pre-exchange)
    plans: constant folding, iterative simplification rules to
    fixpoint, then one channel-pruning pass, then a final rule sweep
    (pruning can expose identity projections)."""
    root = fold_plan_constants(root)
    opt = IterativeOptimizer(DEFAULT_RULES if rules is None else rules)
    root = opt.optimize(root)
    if prune:
        root = prune_unreferenced(root)
        root = opt.optimize(root)
    return root
