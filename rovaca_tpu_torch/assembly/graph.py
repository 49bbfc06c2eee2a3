"""Read-threading de Bruijn graph, sequence graph, and K-best haplotypes.

Reimplements the reference's assembler core (reference: src/haplotypecaller/
apply/assemble/hc_assemble_read_threading_graph.c,
hc_assemble_read_threading_assembler.c:42-143, hc_assemble_chain_pruner.c,
hc_assemble_seq_graph.c, hc_assemble_dijkstra_shortest_path.c; all GATK
ReadThreadingAssembler semantics) with plain Python data structures:

- kmers that repeat within any single input sequence are "non-unique"; reads
  start threading at their first unique kmer; non-unique kmers get a fresh
  vertex per context (repeat-safe threading)
- low-weight chain pruning (all edges multiplicity < 2, no ref edge)
- cycle detection fails assembly for this kmer size (callers retry larger k)
- low-complexity check: non-unique kmers * 4 > vertex count fails assembly
- conversion to a sequence graph with linear chains zipped
- K-best haplotype search: priority queue by path score (sum of
  log10(edge multiplicity / total outgoing)), per-vertex expansion cap and
  result cap of 128, deterministic tie-breaks by path sequence
"""

import heapq
import itertools
import math

from .. import constants as C

PRUNE_FACTOR = 2          # hc_assemble.h:16
LOW_QUAL_MUL = 4          # hc_assemble_read_threading_assembler.c:25
MAX_HAPLOTYPES = 128      # hc_assemble_dijkstra_shortest_path.c:22
MIN_ASSEMBLY_QUAL = 10    # hc_assemble.h:9 (usable_for_assembly threshold)


class Vertex:
    __slots__ = ("kmer", "uid", "in_edges", "out_edges")
    _ids = itertools.count()

    def __init__(self, kmer):
        self.kmer = kmer
        self.uid = next(Vertex._ids)
        self.in_edges = {}    # source Vertex -> Edge
        self.out_edges = {}   # target Vertex -> Edge

    @property
    def in_degree(self):
        return len(self.in_edges)

    @property
    def out_degree(self):
        return len(self.out_edges)

    def __repr__(self):
        return f"V({self.kmer.decode()}#{self.uid})"


class Edge:
    __slots__ = ("multiplicity", "is_ref")

    def __init__(self, multiplicity=0, is_ref=False):
        self.multiplicity = multiplicity
        self.is_ref = is_ref


def _sequence_kmer_counts(seq, k):
    counts = {}
    for i in range(len(seq) - k + 1):
        km = seq[i:i + k]
        counts[km] = counts.get(km, 0) + 1
    return counts


class ReadThreadingGraph:
    """GATK-style read-threading graph for one kmer size."""

    def __init__(self, kmer_size):
        self.k = kmer_size
        self.vertices = []
        self.unique_vertex = {}       # kmer -> Vertex (unique kmers only)
        self.non_unique = set()
        self.ref_source = None
        self.ref_sink = None

    # --- construction ---
    def determine_non_unique_kmers(self, sequences):
        """Kmers occurring more than once within any single sequence
        (GATK determineNonUniques)."""
        k = self.k
        nu = self.non_unique
        for seq in sequences:
            seen = set()
            add_seen = seen.add
            for i in range(len(seq) - k + 1):
                km = seq[i:i + k]
                if km in seen:
                    nu.add(km)
                else:
                    add_seen(km)

    def ref_has_non_unique_kmers(self, ref):
        return any(n > 1 for n in _sequence_kmer_counts(ref, self.k).values())

    def _new_vertex(self, kmer, unique):
        v = Vertex(kmer)
        self.vertices.append(v)
        if unique:
            self.unique_vertex[kmer] = v
        return v

    def _get_or_create(self, kmer):
        if kmer in self.non_unique:
            return self._new_vertex(kmer, unique=False)
        v = self.unique_vertex.get(kmer)
        if v is None:
            v = self._new_vertex(kmer, unique=True)
        return v

    def _add_edge(self, u, v, is_ref):
        e = u.out_edges.get(v)
        if e is None:
            e = Edge(0, False)
            u.out_edges[v] = e
            v.in_edges[u] = e
        e.multiplicity += 1
        e.is_ref |= is_ref
        return e

    def thread_sequence(self, seq, is_ref=False):
        """Thread one sequence through the graph (GATK threadSequence)."""
        k = self.k
        if len(seq) < k:
            return
        if is_ref:
            start = 0
        else:
            # the reference's start scan EXCLUDES the final kmer position
            # (find_seq_kmer_start: i < len - kmer,
            # hc_assemble_read_threading_graph.c:126-146)
            start = None
            for i in range(len(seq) - k):
                if seq[i:i + k] not in self.non_unique:
                    start = i
                    break
            if start is None:
                return
        v = self._get_or_create(seq[start:start + k])
        # propagate support backwards from the threading start: edges into
        # the starting vertex whose chain spells the starting kmer get +1
        # (hc_assemble_graph_increase_counts_in_matched_kmers,
        # hc_assemble_read_threading_graph.c:187-208; GATK
        # increaseCountsInMatchedKmers). Without this, reads whose first
        # unique kmer lands mid-chain leave weight-1 dips that break the
        # dangling-end LCA walk's prune-factor reset.
        kmer0 = seq[start:start + k]
        cur, off = v, k - 2
        while off >= 0 and cur.in_degree == 1:
            (prev, edge) = next(iter(cur.in_edges.items()))
            if prev.kmer[-1] != kmer0[off]:
                break
            edge.multiplicity += 1
            cur, off = prev, off - 1
        if is_ref:
            self.ref_source = v
        for i in range(start + 1, len(seq) - k + 1):
            nb = seq[i + k - 1]  # int byte: avoids slicing in the scan below
            # extend along an existing out-edge whose vertex ends in next_base
            target = None
            for cand in v.out_edges:
                if cand.kmer[-1] == nb:
                    target = cand
                    break
            if target is None:
                kmer = seq[i:i + k]
                if (not is_ref and self.ref_source is not None
                        and kmer == self.ref_source.kmer):
                    # never merge a read path back into the reference
                    # SOURCE vertex — a fresh duplicate is created instead
                    # (get_kmer_vertex, hc_assemble_read_threading_graph.c:
                    # 235-250)
                    target = self._new_vertex(kmer, unique=False)
                else:
                    target = self._get_or_create(kmer)
                e = Edge(0, False)
                v.out_edges[target] = e
                target.in_edges[v] = e
            else:
                e = v.out_edges[target]
            e.multiplicity += 1
            e.is_ref |= is_ref
            v = target
        if is_ref:
            self.ref_sink = v

    # --- graph cleanup ---
    def remove_vertices(self, dead):
        dead = set(dead)
        for v in dead:
            for u, e in list(v.in_edges.items()):
                u.out_edges.pop(v, None)
            for w, e in list(v.out_edges.items()):
                w.in_edges.pop(v, None)
        self.vertices = [v for v in self.vertices if v not in dead]
        self.unique_vertex = {k: v for k, v in self.unique_vertex.items()
                              if v not in dead}

    def has_cycle(self):
        """Iterative 3-color DFS over the whole graph."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {v: WHITE for v in self.vertices}
        for root in self.vertices:
            if color[root] != WHITE:
                continue
            stack = [(root, iter(root.out_edges))]
            color[root] = GRAY
            while stack:
                v, it = stack[-1]
                adv = next(it, None)
                if adv is None:
                    color[v] = BLACK
                    stack.pop()
                elif color[adv] == GRAY:
                    return True
                elif color[adv] == WHITE:
                    color[adv] = GRAY
                    stack.append((adv, iter(adv.out_edges)))
        return False

    def is_low_quality(self):
        """Non-unique kmers more than ~20% of vertices
        (hc_assemble_graph_is_low_quality_graph)."""
        return len(self.non_unique) * LOW_QUAL_MUL > max(1, len(self.vertices))

    def prune_low_weight_chains(self, prune_factor=PRUNE_FACTOR):
        """Remove linear chains where every edge has multiplicity <
        prune_factor and none is a reference edge (hc_assemble_chain_pruner.c).

        Discovery and removal are TWO phases: chains are enumerated from the
        graph sources (chain ends become new chain starts) on the FROZEN
        graph, then removed together. Interleaving them is order-dependent:
        removing one of two error paths that merge before a supported tail
        degrades the merge vertex to a pass-through, and the second chain's
        walk then runs into the supported tail and is spared
        (hc_assemble_chain_pruner.c:28-60 collects all_path first)."""
        chain_starts = [v for v in self.vertices
                        if v.in_degree == 0 and v.out_degree]
        seen_starts = set(id(v) for v in chain_starts)
        chains = []
        qi = 0
        while qi < len(chain_starts):
            u = chain_starts[qi]
            qi += 1
            for v0, e0 in u.out_edges.items():
                chain = [(u, v0, e0)]
                last = v0
                while (last.out_degree == 1 and last.in_degree <= 1
                       and last is not u):
                    (nxt, e) = next(iter(last.out_edges.items()))
                    chain.append((last, nxt, e))
                    last = nxt
                chains.append(chain)
                if id(last) not in seen_starts:
                    seen_starts.add(id(last))
                    chain_starts.append(last)
        removed = 0
        for chain in chains:
            if all(e.multiplicity < prune_factor and not e.is_ref
                   for _, _, e in chain):
                for a, b, e in chain:
                    if a.out_edges.get(b) is e:
                        del a.out_edges[b]
                        del b.in_edges[a]
                removed += 1
        self.remove_singleton_orphans()
        return removed

    def remove_singleton_orphans(self):
        dead = [v for v in self.vertices
                if v.in_degree == 0 and v.out_degree == 0
                and v is not self.ref_source]
        if dead:
            self.remove_vertices(dead)

    def remove_paths_not_connected_to_ref(self):
        """Keep vertices on some ref_source -> ref_sink path direction-wise
        (hc_assemble_graph_remove_paths_not_connected_to_ref)."""
        fwd = self._reach(self.ref_source, forward=True)
        bwd = self._reach(self.ref_sink, forward=False)
        keep = fwd & bwd
        self.remove_vertices([v for v in self.vertices if v not in keep])

    def _reach(self, start, forward):
        seen = set()
        if start is None:
            return seen
        stack = [start]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            nxt = v.out_edges if forward else v.in_edges
            stack.extend(n for n in nxt if n not in seen)
        return seen

    # --- dangling-end recovery (hc_assemble_base_graph.c:123-930; GATK
    #     recoverDanglingTails / recoverDanglingHeads legacy) ---
    MIN_DANGLING_BRANCH_LENGTH = 4     # hc_assemble_base_graph.h:5
    MAX_CIGAR_COMPLEXITY = 3

    def _is_reference_vertex(self, v):
        return (any(e.is_ref for e in v.out_edges.values())
                or any(e.is_ref for e in v.in_edges.values()))

    @staticmethod
    def _has_ref_out_edge(v):
        """is_reference_node (hc_assemble_base_graph.c:414-425): only a
        reference OUT-edge qualifies (the ref sink does not)."""
        return v is not None and any(e.is_ref for e in v.out_edges.values())

    def _path_bases(self, path, expand_source=False):
        out = []
        for i, v in enumerate(path):
            if expand_source and v.in_degree == 0:
                out.append(v.kmer)
            else:
                out.append(v.kmer[-1:])
        return b"".join(out)

    def _find_path_upwards_to_lca(self, vertex, prune_factor=PRUNE_FACTOR):
        """[LCA, ..., vertex] or None (find_path_upwards_to_lowest_common_
        ancestor; low-weight edges reset the collected path)."""
        path = []
        visited = set()
        v = vertex
        while (v is not None and v.in_degree == 1
               and not (v.in_degree != 1 or v.out_degree >= 2)):
            (parent, edge) = next(iter(v.in_edges.items()))
            if edge.multiplicity < prune_factor:
                path = []
            else:
                path.insert(0, v)
            v = parent
            if id(v) in visited:
                return None
            visited.add(id(v))
        if v is not None:
            path.insert(0, v)
        if v is not None and v.out_degree > 1:
            return path
        return None

    @staticmethod
    def _heaviest_incoming_edge(v):
        """Heaviest incoming edge with multiplicity > 1, or None
        (hc_assemble_base_graph_get_heaviest_incoming_edge)."""
        best = None
        for _parent, e in v.in_edges.items():
            if e.multiplicity == 1:
                continue
            if best is None or e.multiplicity > best.multiplicity:
                best = e
        return best

    def _reference_path_downward(self, start, blacklisted_edge):
        """Downward path from `start`: a reference edge when present, else
        the single non-blacklisted outgoing edge; None on a cycle
        (get_reference_path + get_next_reference_vertex with
        allowNonRefPaths=1, hc_assemble_base_graph.c:212-309)."""
        path = [start]
        seen = {id(start)}
        v = start
        while True:
            nxt = None
            for w, e in v.out_edges.items():
                if e.is_ref:
                    nxt = w
                    break
            if nxt is None:
                cand = [w for w, e in v.out_edges.items()
                        if e is not blacklisted_edge]
                nxt = cand[0] if len(cand) == 1 else None
            if nxt is None:
                break
            if id(nxt) in seen:
                return None
            path.append(nxt)
            seen.add(id(nxt))
            v = nxt
        return path

    def _reference_path_from(self, start, forward):
        """Vertices from `start` following reference edges."""
        path = [start]
        v = start
        seen = {id(start)}
        while True:
            nxt = None
            edges = v.out_edges if forward else v.in_edges
            for w, e in edges.items():
                if e.is_ref:
                    nxt = w
                    break
            if nxt is None or id(nxt) in seen:
                break
            path.append(nxt)
            seen.add(id(nxt))
            v = nxt
        return path

    @staticmethod
    def _longest_suffix_match(ref_seq, alt_seq, ref_end_index):
        n = 0
        i, j = ref_end_index, len(alt_seq) - 1
        while i >= 0 and j >= 0 and ref_seq[i] == alt_seq[j]:
            n += 1
            i -= 1
            j -= 1
        return n

    def recover_dangling_tails(self):
        from .sw import DANGLING_END_PARAMS, OverhangStrategy, sw_align
        from ..reads.cigar import CigarOp

        recovered = 0
        for v in list(self.vertices):
            if v.out_degree != 0 or v is self.ref_sink:
                continue
            path = self._find_path_upwards_to_lca(v)
            if (path is None
                    or len(path) < self.MIN_DANGLING_BRANCH_LENGTH + 1
                    or path[0] is self.ref_source):
                continue
            lca = path[0]
            # the LCA need NOT be a reference vertex: the downward "ref"
            # path follows ref edges where present and otherwise the single
            # non-blacklisted outgoing edge (get_next_reference_vertex with
            # allowNonRefPaths, hc_assemble_base_graph.c:212-260) — this is
            # what reconnects dangling tails that branch off ALT paths
            blacklisted = (self._heaviest_incoming_edge(path[1])
                           if len(path) > 1 else None)
            ref_path = self._reference_path_downward(lca, blacklisted)
            if ref_path is None or len(ref_path) < 2:
                continue
            alt_seq = self._path_bases(path)
            ref_seq = self._path_bases(ref_path)
            try:
                res = sw_align(ref_seq, alt_seq, DANGLING_END_PARAMS,
                               OverhangStrategy.LEADING_INDEL)
            except ValueError:
                continue
            elems = [list(e) for e in res.cigar.elements]
            while elems and elems[-1][0] in (CigarOp.D,):
                elems.pop()
            if not elems or len(elems) > self.MAX_CIGAR_COMPLEXITY:
                continue
            if elems[-1][0] != CigarOp.M:
                continue
            last_ref_index = sum(n for op, n in elems
                                 if op in (CigarOp.M, CigarOp.D)) - 1
            matching_suffix = min(
                self._longest_suffix_match(ref_seq, alt_seq, last_ref_index),
                elems[-1][1])
            if matching_suffix == 0:
                continue
            cigar_read_len = sum(n for op, n in elems
                                 if op in (CigarOp.M, CigarOp.I))
            alt_index = max(cigar_read_len - matching_suffix - 1, 0)
            leading_del = (elems[0][0] == CigarOp.D
                           and elems[0][1] + matching_suffix
                           == last_ref_index + 1)
            ref_index = (last_ref_index - matching_suffix + 1
                         + (1 if leading_del else 0))
            if ref_index == 0 or ref_index >= len(ref_path) \
                    or alt_index >= len(path):
                continue
            alt_v = path[alt_index]
            ref_v = ref_path[ref_index]
            if ref_v not in alt_v.out_edges:
                e = Edge(1, False)
                alt_v.out_edges[ref_v] = e
                ref_v.in_edges[alt_v] = e
                recovered += 1
        return recovered

    def recover_dangling_heads(self):
        """Legacy head recovery: prefix match on reversed sequences with a
        mismatch budget of branch_length/kmer
        (merge_dangling_head_legacy, best_prefix_match_legacy)."""
        from .sw import DANGLING_END_PARAMS, OverhangStrategy, sw_align
        from ..reads.cigar import CigarOp

        recovered = 0
        for v in list(self.vertices):
            if v.in_degree != 0 or v is self.ref_source:
                continue
            # walk down to the highest common descendant on the ref path;
            # LOW-WEIGHT edges reset the collected path — a branch whose
            # edges never reach the prune factor cannot be recovered
            # (find_path_downwards_to_highest_common_descendant_of_
            # reference, hc_assemble_base_graph.c:440-485). This is what
            # keeps 1-read sequencing-error branches out of the graph.
            path = []
            w = v
            ok = True
            visited = {id(v)}
            while (w is not None and w.out_degree
                   and not (self._has_ref_out_edge(w) or w.out_degree != 1)):
                (nxt, edge) = next(iter(w.out_edges.items()))
                if edge.multiplicity < PRUNE_FACTOR:
                    path = []
                else:
                    path.append(w)
                w = nxt
                if id(w) in visited:
                    ok = False
                    break
                visited.add(id(w))
            if w is not None:
                path.append(w)
            if not ok or not self._has_ref_out_edge(w):
                continue
            if len(path) < self.MIN_DANGLING_BRANCH_LENGTH + 1:
                continue
            hcd = path[-1]
            if hcd is self.ref_sink:
                continue
            alt_path = list(reversed(path))       # [HCD, ..., head]
            ref_path = self._reference_path_from(hcd, forward=False)
            if len(ref_path) < 2:
                continue
            # reversed-orientation bases walking outward from the HCD; the
            # in-degree-0 endpoint contributes its whole kmer reversed
            # (GATK getBasesForPath(expandSource=true))
            alt_seq = b"".join(
                v.kmer[::-1] if v.in_degree == 0 else v.kmer[-1:]
                for v in alt_path)
            ref_seq = b"".join(
                v.kmer[::-1] if v.in_degree == 0 else v.kmer[-1:]
                for v in ref_path)
            try:
                res = sw_align(ref_seq, alt_seq, DANGLING_END_PARAMS,
                               OverhangStrategy.LEADING_INDEL)
            except ValueError:
                continue
            elems = list(res.cigar.elements)
            if not elems or len(elems) > self.MAX_CIGAR_COMPLEXITY \
                    or elems[0][0] != CigarOp.M:
                continue
            max_index = min(elems[0][1], len(ref_seq), len(alt_seq))
            # the reference's budget divides the PREFIX LENGTH CONSIDERED
            # (maxIndex = first cigar element length), not the dangling
            # branch's vertex count — get_max_mismatches_legacy is called
            # with maxIndex (hc_assemble_base_graph.c:704-707,829); using
            # len(path) under-budgets long prefixes and loses recoveries
            # (round-5 fresh-seed divergence, chr20:250486 @ seed 31337)
            max_mismatches = max(1, max_index // self.k)
            mismatches = 0
            last_good = -1
            for idx in range(max_index):
                if ref_seq[idx] != alt_seq[idx]:
                    mismatches += 1
                    if mismatches > max_mismatches:
                        last_good = -1
                        break
                    last_good = idx
            indexes_to_merge = last_good
            if indexes_to_merge <= 0:
                continue
            if indexes_to_merge >= len(ref_path) - 1:
                continue
            if indexes_to_merge >= len(alt_path):
                alt_path = self._extend_dangling_path(
                    alt_path, ref_path, res.cigar,
                    indexes_to_merge - len(alt_path) + 2)
                if alt_path is None:
                    continue
            from_v = ref_path[indexes_to_merge + 1]
            to_v = alt_path[indexes_to_merge]
            if to_v not in from_v.out_edges:
                e = Edge(1, False)
                from_v.out_edges[to_v] = e
                to_v.in_edges[from_v] = e
                recovered += 1
        return recovered

    def _extend_dangling_path(self, alt_path, ref_path, cigar, n_extend):
        """Extend a dangling head path upstream with reference bases
        (extend_dangling_path_against_reference,
        hc_assemble_base_graph.c:757-813)."""
        from ..reads.cigar import CigarOp

        ref_len = sum(n for op, n in cigar
                      if op in (CigarOp.M, CigarOp.D))
        read_len = sum(n for op, n in cigar
                       if op in (CigarOp.M, CigarOp.I))
        offset = ref_len - read_len
        index_of_ref_node = len(alt_path) - 1 + offset + n_extend
        if not (0 <= index_of_ref_node < len(ref_path)):
            return None

        dangling_source = alt_path[-1]
        alt_path = alt_path[:-1]
        ref_v = ref_path[index_of_ref_node]
        seq = ref_v.kmer[:n_extend] + dangling_source.kmer

        # drop the old source and its edge; rebuild extended chain
        out_items = list(dangling_source.out_edges.items())
        if not out_items:
            return None
        prev_v, source_edge = out_items[0]
        weight = source_edge.multiplicity
        del dangling_source.out_edges[prev_v]
        del prev_v.in_edges[dangling_source]

        for i in range(n_extend, 0, -1):
            kmer = seq[i:i + self.k]
            new_v = self._new_vertex(kmer, unique=False)
            e = Edge(weight, False)
            new_v.out_edges[prev_v] = e
            prev_v.in_edges[new_v] = e
            alt_path.append(new_v)
            prev_v = new_v
        return alt_path

    def to_sequence_graph(self):
        """Each vertex contributes its last base; the ref source contributes
        its whole kmer (GATK convertToSequenceGraph)."""
        sg = SeqGraph()
        mapping = {}
        for v in self.vertices:
            seq = v.kmer if v is self.ref_source else v.kmer[-1:]
            mapping[v] = sg.add_vertex(seq)
        for v in self.vertices:
            for w, e in v.out_edges.items():
                sg.add_edge(mapping[v], mapping[w], e.multiplicity, e.is_ref)
        sg.ref_source = mapping.get(self.ref_source)
        sg.ref_sink = mapping.get(self.ref_sink)
        return sg


class SeqVertex:
    __slots__ = ("seq", "uid", "in_edges", "out_edges")

    def __init__(self, seq, uid):
        self.seq = seq
        self.uid = uid
        self.in_edges = {}
        self.out_edges = {}

    @property
    def in_degree(self):
        return len(self.in_edges)

    @property
    def out_degree(self):
        return len(self.out_edges)

    def __repr__(self):
        return f"S({self.seq.decode()}#{self.uid})"


class SeqGraph:
    def __init__(self):
        self.vertices = []
        self.ref_source = None
        self.ref_sink = None
        self._uid = itertools.count()

    def add_vertex(self, seq):
        v = SeqVertex(seq, next(self._uid))
        self.vertices.append(v)
        return v

    def add_edge(self, u, v, multiplicity=1, is_ref=False):
        e = u.out_edges.get(v)
        if e is None:
            e = Edge(0, False)
            u.out_edges[v] = e
            v.in_edges[u] = e
        e.multiplicity += multiplicity
        e.is_ref |= is_ref
        return e

    def remove_vertices(self, dead):
        dead = set(dead)
        for v in dead:
            for u in list(v.in_edges):
                u.out_edges.pop(v, None)
            for w in list(v.out_edges):
                w.in_edges.pop(v, None)
        self.vertices = [v for v in self.vertices if v not in dead]

    @staticmethod
    def _is_ref_node(v):
        """Vertex on the reference path: any outgoing ref edge
        (hc_assemble_seq_graph_is_reference_node, :121-132)."""
        return any(e.is_ref for e in v.out_edges.values())

    def _is_linear_chain_start(self, v):
        """out==1 and (in != 1 or the sole parent branches)
        (hc_assemble_seq_graph_is_linear_chain_start, :91-116)."""
        if v.out_degree != 1:
            return False
        if v.in_degree != 1:
            return True
        (parent,) = v.in_edges.keys()
        return parent.out_degree > 1

    def _trace_linear_chain(self, zip_start):
        """[zip_start, ...] extended while last.out==1, target.in==1,
        target is not last, and both share is-ref state; the final member
        MAY have out-degree != 1 (hc_assemble_seq_graph_trace_linear_chain,
        :144-178)."""
        chain = [zip_start]
        last = zip_start
        last_is_ref = self._is_ref_node(last)
        while last.out_degree == 1:
            (target,) = last.out_edges.keys()
            if target.in_degree != 1 or target is last:
                break
            target_is_ref = self._is_ref_node(target)
            if last_is_ref != target_is_ref:
                break
            chain.append(target)
            last = target
            last_is_ref = target_is_ref
        return chain

    def _merge_linear_chain(self, chain):
        """Replace a >=2 chain with one combined vertex: first's in-edges
        and last's out-edges rewire to it, keeping edge objects
        (hc_assemble_seq_graph_merge_linear_chain, :239-276)."""
        if len(chain) < 2:
            return False
        merged = self.add_vertex(b"".join(v.seq for v in chain))
        first, last = chain[0], chain[-1]
        for w, e in list(last.out_edges.items()):
            del last.out_edges[w]
            del w.in_edges[last]
            merged.out_edges[w] = e
            w.in_edges[merged] = e
        for u, e in list(first.in_edges.items()):
            del first.in_edges[u]
            del u.out_edges[first]
            merged.in_edges[u] = e
            u.out_edges[merged] = e
        in_chain = set(id(v) for v in chain)
        if id(self.ref_source) in in_chain:
            self.ref_source = merged
        if id(self.ref_sink) in in_chain:
            self.ref_sink = merged
        self.remove_vertices(chain)
        return True

    def zip_linear_chains(self):
        """Zip every simple linear chain into one combined vertex
        (hc_assemble_seq_graph_zip_linear_chains, :287-326): chain starts
        are collected on the frozen graph, each chain is traced (its last
        member may branch or terminate) and merged when >= 2 long.
        Returns True if any merge happened (simplify counts zipping as
        work done)."""
        zip_starts = [v for v in self.vertices
                      if self._is_linear_chain_start(v)]
        merged_one = False
        for zs in zip_starts:
            chain = self._trace_linear_chain(zs)
            merged_one |= self._merge_linear_chain(chain)
        return merged_one

    def remove_singleton_orphans(self):
        dead = [v for v in self.vertices
                if v.in_degree == 0 and v.out_degree == 0
                and v is not self.ref_source]
        if dead:
            self.remove_vertices(dead)

    # --- simplification: faithful port of the reference's vertex-sequence
    #     splitter (hc_assemble_vertex_sequence_spliter.c; GATK
    #     MergeDiamonds / CommonSuffixSplitter / MergeCommonSuffices).
    #     Each op's driver restarts the vertex scan after every single
    #     transform (HC_ASSEMBLE_SEQ_GRAPH_SIMLIFY macro,
    #     hc_assemble_seq_graph.h:19-47). ---

    def _is_ref_source_vertex(self, v):
        """No incoming ref edge + some outgoing ref edge
        (hc_assemble_base_graph_is_ref_source, :972-996)."""
        if any(e.is_ref for e in v.in_edges.values()):
            return False
        return any(e.is_ref for e in v.out_edges.values())

    def _is_ref_sink_vertex(self, v):
        if any(e.is_ref for e in v.out_edges.values()):
            return False
        return any(e.is_ref for e in v.in_edges.values())

    def rederive_ref_endpoints(self):
        """Re-identify ref source/sink from edge flags, first match in
        vertex order (get_reference_source/sink_vertex_with_head,
        hc_assemble_utils.c:604-618) — the reference re-derives them after
        simplification rather than tracking through transforms."""
        self.ref_source = next((v for v in self.vertices
                                if self._is_ref_source_vertex(v)), None)
        self.ref_sink = next((v for v in self.vertices
                              if self._is_ref_sink_vertex(v)), None)

    @staticmethod
    def _common_prefix_suffix_len(seqs):
        """(prefix_len, suffix_len) with the suffix bounded by
        min_len - prefix_len (common_prefix_and_suffix_of_vertices,
        hc_assemble_vertex_sequence_spliter.c:676-707)."""
        min_len = min(len(s) for s in seqs)
        first = seqs[0]
        pre = 0
        while pre < min_len and all(s[pre] == first[pre] for s in seqs[1:]):
            pre += 1
        lim = min_len - pre
        suf = 0
        while suf < lim and all(s[len(s) - 1 - suf] ==
                                first[len(first) - 1 - suf]
                                for s in seqs[1:]):
            suf += 1
        return pre, suf

    @staticmethod
    def _link_fresh(u, w, mult, is_ref):
        e = Edge(mult, is_ref)
        u.out_edges[w] = e
        w.in_edges[u] = e
        return e

    def _try_merge_diamond(self, top):
        """top -> {middles} -> bottom: split the middles' shared
        prefix/suffix out (merge_diamonds_try_to_transform, :75-146 +
        split/update_graph :803-1070)."""
        if top.out_degree <= 1:
            return False
        middles = list(top.out_edges.keys())
        bottom = None
        for mi in middles:
            if mi.out_degree < 1 or mi.in_degree != 1:
                return False
            for mt in mi.out_edges:
                if bottom is None:
                    bottom = mt
                elif bottom is not mt:
                    return False
        if bottom.in_degree != len(middles):
            return False
        seqs = [m.seq for m in middles]
        pre, suf = self._common_prefix_suffix_len(seqs)
        if pre < 1 and suf < 1:
            return False
        self._split_and_update(middles, top, bottom, pre, suf)
        return True

    def _split_and_update(self, middles, top, bottom, pre, suf):
        """Build the split subgraph (prefix -> remainders -> suffix), then
        graft it between top and bottom (spliter_split :819-870 +
        update_graph :880-1070)."""
        first = middles[0].seq
        prefix_seq = first[:pre]
        suffix_seq = first[len(first) - suf:] if suf else b""
        # split graph: fresh vertices NOT registered in self.vertices
        prefix_sv = SeqVertex(prefix_seq, next(self._uid))
        suffix_sv = SeqVertex(suffix_seq, next(self._uid))
        mapping = []   # (split_middle_vertex, outer_twin) in order
        for mid in middles:
            e_to = next(iter(mid.in_edges.values()))     # sole in-edge
            e_from = next(iter(mid.out_edges.values()))  # sole out-edge
            rem_seq = mid.seq[pre:len(mid.seq) - suf]
            if rem_seq:
                rv = SeqVertex(rem_seq, next(self._uid))
                mapping.append([rv, None])
                self._link_fresh(prefix_sv, rv, e_to.multiplicity,
                                 e_to.is_ref)
                self._link_fresh(rv, suffix_sv, e_from.multiplicity,
                                 e_from.is_ref)
            else:
                # prefix + suffix fully explain this middle
                w = e_to.multiplicity + e_from.multiplicity
                r = e_to.is_ref or e_from.is_ref
                e = prefix_sv.out_edges.get(suffix_sv)
                if e is None:
                    self._link_fresh(prefix_sv, suffix_sv, w, r)
                else:
                    e.multiplicity += w
                    e.is_ref |= r

        self.remove_vertices(middles)
        for entry in mapping:
            entry[1] = self.add_vertex(entry[0].seq)
        outer_of = {id(rv): ov for rv, ov in mapping}

        has_ps_edge = suffix_sv in prefix_sv.out_edges
        has_only_ps = has_ps_edge and len(prefix_sv.out_edges) == 1
        need_prefix = pre > 0 or (top is None and not has_only_ps)
        need_suffix = suf > 0 or (bottom is None and not has_only_ps)
        if need_prefix:
            pv_main = self.add_vertex(prefix_seq)
            if top is not None:
                is_ref = any(e.is_ref
                             for e in prefix_sv.out_edges.values())
                self._link_fresh(top, pv_main, 1, is_ref)
            top_for = pv_main
        else:
            top_for = top
        if need_suffix:
            sv_main = self.add_vertex(suffix_seq)
            if bottom is not None:
                is_ref = any(e.is_ref
                             for e in suffix_sv.in_edges.values())
                self._link_fresh(sv_main, bottom, 1, is_ref)
            bot_for = sv_main
        else:
            bot_for = bottom

        if top_for is not None:
            for target, e in prefix_sv.out_edges.items():
                if target is suffix_sv:
                    if bot_for is None or bot_for in top_for.out_edges:
                        continue
                    self._link_fresh(top_for, bot_for, e.multiplicity,
                                     e.is_ref)
                else:
                    ov = outer_of[id(target)]
                    if ov in top_for.out_edges:
                        continue
                    self._link_fresh(top_for, ov, e.multiplicity, e.is_ref)
        if bot_for is not None:
            for source, e in suffix_sv.in_edges.items():
                ov = outer_of.get(id(source))
                if ov is None:   # the prefix vertex: handled above
                    continue
                if bot_for in ov.out_edges:
                    continue
                self._link_fresh(ov, bot_for, e.multiplicity, e.is_ref)

    def _try_split_common_suffix(self, bottom, already_split):
        """Split each incoming vertex of `bottom` into prefix + its own
        suffix copy (split_common_suffices_try_to_transform :212-237 +
        common_suffix_splitter_split :545-605)."""
        if id(bottom) in already_split:
            return False
        already_split.add(id(bottom))
        if bottom.in_degree < 2:
            return False
        to_split = list(bottom.in_edges.keys())
        # safe_to_split (:472-491)
        for m in to_split:
            if m is bottom or m.out_degree != 1 \
                    or bottom not in m.out_edges:
                return False
            if m in bottom.out_edges:
                return False
        min_len = min(len(m.seq) for m in to_split)
        first = to_split[0].seq
        suf = 0
        while suf < min_len and all(m.seq[len(m.seq) - 1 - suf] ==
                                    first[len(first) - 1 - suf]
                                    for m in to_split[1:]):
            suf += 1
        if suf == 0:
            return False
        # would_eliminate_ref_source (:489-507)
        for m in to_split:
            if self._is_ref_source_vertex(m):
                if len(m.seq) == suf:
                    return False
                break
        if all(len(m.seq) == suf for m in to_split):
            return False
        suffix_seq = first[len(first) - suf:]
        for mid in to_split:
            out_e = next(iter(mid.out_edges.values()))
            out_target = next(iter(mid.out_edges.keys()))
            suffix_v = self.add_vertex(suffix_seq)
            prefix_seq = mid.seq[:len(mid.seq) - suf]
            if not prefix_seq:
                incoming_target = suffix_v
            else:
                incoming_target = self.add_vertex(prefix_seq)
                self._link_fresh(incoming_target, suffix_v, 1,
                                 out_e.is_ref)
            self._link_fresh(suffix_v, out_target, 1, out_e.is_ref)
            for parent, pe in list(mid.in_edges.items()):
                self._link_fresh(parent, incoming_target,
                                 pe.multiplicity, pe.is_ref)
        self.remove_vertices(to_split)
        return True

    def _try_merge_common_suffix(self, v):
        """Merge v with its incoming vertices when they all carry the same
        sequence, each has v as its only child, and none is a source
        (split_merge_common_suffices :239-328 + can_merge :330-352)."""
        prevs = list(v.in_edges.keys())
        if not prevs:
            return False
        first = prevs[0]
        for p in prevs:
            if p.seq != first.seq or p.out_degree != 1:
                return False
            if next(iter(p.out_edges.keys())) is not v:
                return False
            if p.in_degree == 0:
                return False
        new_v = self.add_vertex(first.seq + v.seq)
        for p in prevs:
            for parent, e in p.in_edges.items():
                existing = parent.out_edges.get(new_v)
                if existing is None:
                    self._link_fresh(parent, new_v, e.multiplicity,
                                     e.is_ref)
        for target, e in v.out_edges.items():
            if target.in_edges.get(new_v) is None:
                self._link_fresh(new_v, target, e.multiplicity, e.is_ref)
        self.remove_vertices(prevs + [v])
        return True

    def _run_to_fixed_point(self, try_fn):
        """Restart the in-order vertex scan after every successful
        transform (HC_ASSEMBLE_SEQ_GRAPH_SIMLIFY, seq_graph.h:19-47)."""
        did_any = False
        found = True
        while found:
            found = False
            for v in list(self.vertices):
                if try_fn(v):
                    found = True
                    did_any = True
                    break
        return did_any

    def merge_diamonds(self):
        return self._run_to_fixed_point(self._try_merge_diamond)

    def split_common_suffixes(self):
        already = set()
        return self._run_to_fixed_point(
            lambda v: self._try_split_common_suffix(v, already))

    def merge_common_suffices(self):
        return self._run_to_fixed_point(self._try_merge_common_suffix)

    MAX_SIMPLIFY_CYCLES = 100    # hc_assemble_seq_graph.h:11
    MAX_CHANGE_LOOPS = 5         # hc_assemble_seq_graph.h:12

    def _snapshot(self):
        """Structure key for the oscillation check (clone_graph /
        equal_graphs, hc_assemble_seq_graph.c:443-452,570-604)."""
        verts = sorted(v.seq for v in self.vertices)
        edges = sorted((u.seq, w.seq, e.multiplicity, e.is_ref)
                       for u in self.vertices
                       for w, e in u.out_edges.items())
        return verts, edges

    def simplify(self):
        """Iterate diamond merge + suffix split + identical merge + zip to
        a fixed point (hc_assemble_seq_graph_simplify_graph,
        hc_assemble_seq_graph.c:427-479): one up-front zip, then up to 100
        cycles where ZIPPING COUNTS AS WORK, with an equal-structure
        oscillation break after 5 cycles."""
        self.zip_linear_chains()
        prev = None
        for i in range(self.MAX_SIMPLIFY_CYCLES):
            changed = self.merge_diamonds()
            changed |= self.split_common_suffixes()
            changed |= self.merge_common_suffices()
            changed |= self.zip_linear_chains()
            if not changed:
                break
            if i > self.MAX_CHANGE_LOOPS:
                snap = self._snapshot()
                if prev is not None and snap == prev:
                    break
                prev = snap

    def remove_vertices_not_connected_to_ref_undirected(self):
        if self.ref_source is None:
            return
        seen = set()
        stack = [self.ref_source]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            stack.extend(n for n in v.in_edges if n not in seen)
            stack.extend(n for n in v.out_edges if n not in seen)
        self.remove_vertices([v for v in self.vertices if v not in seen])


def find_k_best_haplotypes(graph, max_haplotypes=MAX_HAPLOTYPES,
                           results_start=0):
    """K-best source->sink paths by log10 edge-frequency score
    (hc_assemble_dijkstra_find_best_haplotypes; GATK
    GraphBasedKBestHaplotypeFinder). Returns [(seq_bytes, score, is_ref)]
    sorted best-first.

    results_start: initial value of the reference's result_size counter.
    The FIRST dijkstra call of a region pre-inserts the full reference
    haplotype into its persistent result list (result_size = 1,
    hc_assemble_dijkstra_shortest_path.c:219-233), so that call collects
    one fewer path than later kmer-size calls (whose counter resets to 0,
    :204). The while cap `result_size <= 128` therefore admits 128 paths
    on the first call and 129 on subsequent ones."""
    source, sink = graph.ref_source, graph.ref_sink
    if source is None or sink is None:
        return []

    results = []
    visit_count = {}
    # tie-break on equal score matches the reference's rbtree comparator
    # (hc_assemble_dijkstra_compare_edge_path): lexicographically LARGER
    # partial sequence pops first, and on a shared prefix the LONGER path
    # wins. Encode that as ascending order of the byte-inverted sequence
    # plus a 0xFF sentinel (greater than any inverted base, so a prefix
    # sorts after its extensions).
    def invkey(seq):
        return bytes(255 - b for b in seq) + b"\xff"

    counter = itertools.count(0, -1)  # LIFO among exactly-equal keys: the
    # reference's rbtree inserts equal-comparing nodes to the LEFT
    # (hc_assemble_dijkstra_shortest_path.c:398-403), so the newest of an
    # exactly-tied pair pops first
    # heap entries: (-score, invkey(seq), tiebreak, seq, vertex, is_ref_path)
    heap = [(0.0, invkey(source.seq), next(counter), source.seq, source,
             True)]
    while heap and results_start + len(results) <= max_haplotypes:
        neg_score, _, _, seq, v, is_ref = heapq.heappop(heap)
        if v is sink:
            results.append((seq, -neg_score, is_ref))
            continue
        visits = visit_count.get(v, 0)
        if visits + 1 >= max_haplotypes:
            continue
        visit_count[v] = visits + 1
        total_out = sum(e.multiplicity for e in v.out_edges.values())
        if total_out == 0:
            continue
        for w, e in v.out_edges.items():
            penalty = (math.log10(e.multiplicity) - math.log10(total_out))
            nseq = seq + w.seq
            heapq.heappush(heap, (neg_score - penalty, invkey(nseq),
                                  next(counter), nseq, w,
                                  is_ref and e.is_ref))
    return results
