"""Per-quality encoder policy table (role parity: c/enc/quality.h's
hasher/lgblock/zopfli strategy table, :121-223 -- one row per quality
instead of thresholds scattered through the pipeline).

The native C tiers (btpu_enc.c cfg_for_quality) carry their own copy
of the match-finder knobs; this table governs the Python/device
pipeline: candidate counts, dictionary probing, context modeling,
block splitting and clustering budgets.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class QualityPolicy:
    num_candidates: int       # matcher candidate slots
    use_dict: bool            # static-dictionary probing
    context_modeling: bool    # 2nd-order literal context model
    min_ctx_literals: int     # literals needed to engage the model
    literal_split: bool       # literal block splitting
    min_split_literals: int
    cmd_dist_split: bool      # command/distance block splitting
    min_split_cmds: int
    dist_context_map: bool
    min_dist_syms: int
    max_lit_trees: int        # clustering budget
    split_chunk: int          # block-splitter chunk size
    optimal_parse: bool       # zopfli-role DP
    dp_candidates: int        # DP candidate slots (host path)
    dist_param_search: bool   # NPOSTFIX/NDIRECT sweep


_BASE = dict(num_candidates=2, use_dict=False, context_modeling=False,
             min_ctx_literals=1024, literal_split=False,
             min_split_literals=4096, cmd_dist_split=False,
             min_split_cmds=2048, dist_context_map=False,
             min_dist_syms=512, max_lit_trees=1, split_chunk=512,
             optimal_parse=False, dp_candidates=8,
             dist_param_search=False)


def _mk(**kw):
    d = dict(_BASE)
    d.update(kw)
    return QualityPolicy(**d)


POLICY = {
    0: _mk(),
    1: _mk(),
    2: _mk(),
    3: _mk(),
    4: _mk(),
    5: _mk(num_candidates=4, use_dict=True, context_modeling=True,
           max_lit_trees=12),
    6: _mk(num_candidates=4, use_dict=True, context_modeling=True,
           max_lit_trees=12),
    7: _mk(num_candidates=4, use_dict=True, context_modeling=True,
           max_lit_trees=12),
    8: _mk(num_candidates=4, use_dict=True, context_modeling=True,
           max_lit_trees=12),
    9: _mk(num_candidates=4, use_dict=True, context_modeling=True,
           literal_split=True, cmd_dist_split=True,
           dist_context_map=True, max_lit_trees=12),
    10: _mk(num_candidates=4, use_dict=True, context_modeling=True,
            literal_split=True, cmd_dist_split=True,
            dist_context_map=True, max_lit_trees=48, split_chunk=128,
            optimal_parse=True, dp_candidates=8,
            dist_param_search=True),
    11: _mk(num_candidates=4, use_dict=True, context_modeling=True,
            literal_split=True, cmd_dist_split=True,
            dist_context_map=True, max_lit_trees=48, split_chunk=128,
            optimal_parse=True, dp_candidates=32,
            dist_param_search=True),
}


def policy(quality: int) -> QualityPolicy:
    return POLICY[max(0, min(11, int(quality)))]
