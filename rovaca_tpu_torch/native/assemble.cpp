// Native local assembler — C++ port of rovaca_tpu/assembly/graph.py +
// assembler.assemble_region's graph pipeline.
//
// The Python implementation is the oracle (golden-matched byte-for-byte
// against the reference binary on the 80-region corpus, reference:
// src/haplotypecaller/apply/assemble/*.c); this port replicates its
// semantics exactly, including container iteration order (Python dicts
// preserve insertion order -> vector adjacency lists here), tie-breaks,
// and the dijkstra result-cap accounting. tests/test_assemble_native.py
// asserts path-level identity on randomized and golden regions.
//
// Exposed C ABI: rovaca_assemble_region (whole kmer ladder) — returns the
// merged haplotype path set in first-seen order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <set>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "sw.cpp"  // rovaca_sw_align: exact GATK SW (dangling-end recovery)
#include "finalize.cpp"  // rovaca_fin::finalize_impl (fused prepare entry)

#include <chrono>
#include <cstdio>
#include <cstdlib>

namespace {

// ROVACA_ASM_PROFILE=1: accumulate per-stage wall time, dump at exit.
struct AsmProf {
    enum Stage { FIN, NONUNIQ, THREAD, PRUNE, DANGLING, SEQGRAPH, KBEST,
                 MERGE, NSTAGE };
    double acc[NSTAGE] = {};
    long calls[NSTAGE] = {};
    bool on = getenv("ROVACA_ASM_PROFILE") != nullptr;
    ~AsmProf() {
        if (!on) return;
        const char* names[] = {"finalize", "non_unique", "threading",
                               "prune_cycle", "dangling", "seqgraph_simplify",
                               "kbest", "merge_align"};
        for (int s = 0; s < NSTAGE; s++)
            fprintf(stderr, "[asmprof] %-18s %8.3fs  (%ld)\n", names[s],
                    acc[s], calls[s]);
    }
};
AsmProf g_prof;

struct ProfScope {
    int stage;
    std::chrono::steady_clock::time_point t0;
    explicit ProfScope(int s) : stage(s) {
        if (g_prof.on) t0 = std::chrono::steady_clock::now();
    }
    ~ProfScope() {
        if (!g_prof.on) return;
        g_prof.acc[stage] += std::chrono::duration<double>(
            std::chrono::steady_clock::now() - t0).count();
        g_prof.calls[stage]++;
    }
};

constexpr int kPruneFactor = 2;        // hc_assemble.h:16
constexpr int kLowQualMul = 4;         // read_threading_assembler.c:25
constexpr int kMaxHaplotypes = 128;    // dijkstra_shortest_path.c:22
constexpr int kMinAssemblyQual = 10;   // hc_assemble.h:9
constexpr int kMinDanglingBranchLength = 4;
constexpr int kMaxCigarComplexity = 3;
// SW_DANGLING_END params (rovaca_tool_args.h:40)
constexpr int kDanglingMatch = 25, kDanglingMismatch = -50,
              kDanglingOpen = -110, kDanglingExtend = -6;
constexpr int kLeadingIndel = 2;  // OverhangStrategy.LEADING_INDEL

using sv = std::string_view;

struct Edge {
    int64_t mult = 0;
    bool is_ref = false;
};

// ---------------------------------------------------------------- RT graph
struct Vertex {
    sv kmer;
    std::vector<std::pair<Vertex*, Edge*>> in_e, out_e;
    bool dead = false;
    int color = 0;

    Edge* find_out(Vertex* w) const {
        for (auto& p : out_e)
            if (p.first == w) return p.second;
        return nullptr;
    }
    Edge* find_in(Vertex* u) const {
        for (auto& p : in_e)
            if (p.first == u) return p.second;
        return nullptr;
    }
    void drop_out(Vertex* w) {
        for (size_t i = 0; i < out_e.size(); i++)
            if (out_e[i].first == w) {
                out_e.erase(out_e.begin() + i);
                return;
            }
    }
    void drop_in(Vertex* u) {
        for (size_t i = 0; i < in_e.size(); i++)
            if (in_e[i].first == u) {
                in_e.erase(in_e.begin() + i);
                return;
            }
    }
    int in_degree() const { return (int)in_e.size(); }
    int out_degree() const { return (int)out_e.size(); }
};

struct SvHash {
    size_t operator()(const sv& s) const {
        return std::hash<sv>{}(s);
    }
};

struct RTGraph {
    int k;
    std::deque<Vertex> pool;
    std::deque<Edge> edge_pool;
    std::deque<std::string> kmer_store;  // synthesized kmers (dangling ext)
    std::vector<Vertex*> vertices;
    std::unordered_map<sv, Vertex*, SvHash> unique_vertex;
    std::unordered_set<sv, SvHash> non_unique;
    Vertex* ref_source = nullptr;
    Vertex* ref_sink = nullptr;

    explicit RTGraph(int kmer) : k(kmer) {}

    Vertex* new_vertex(sv kmer, bool unique) {
        pool.push_back(Vertex{});
        Vertex* v = &pool.back();
        v->kmer = kmer;
        vertices.push_back(v);
        if (unique) unique_vertex.emplace(kmer, v);
        return v;
    }

    Vertex* get_or_create(sv kmer) {
        if (non_unique.count(kmer)) return new_vertex(kmer, false);
        auto it = unique_vertex.find(kmer);
        if (it != unique_vertex.end()) return it->second;
        return new_vertex(kmer, true);
    }

    Edge* link(Vertex* u, Vertex* v, int64_t mult, bool is_ref) {
        edge_pool.push_back(Edge{mult, is_ref});
        Edge* e = &edge_pool.back();
        u->out_e.emplace_back(v, e);
        v->in_e.emplace_back(u, e);
        return e;
    }

    void determine_non_unique(const std::vector<sv>& seqs) {
        std::unordered_set<sv, SvHash> seen;
        for (const sv& seq : seqs) {
            if ((int64_t)seq.size() < k) continue;
            seen.clear();
            for (size_t i = 0; i + k <= seq.size(); i++) {
                sv km = seq.substr(i, k);
                if (!seen.insert(km).second) non_unique.insert(km);
            }
        }
    }

    bool ref_has_non_unique(sv ref) const {
        std::unordered_set<sv, SvHash> seen;
        for (size_t i = 0; i + k <= ref.size(); i++)
            if (!seen.insert(ref.substr(i, k)).second) return true;
        return false;
    }

    void thread_sequence(sv seq, bool is_ref) {
        if ((int64_t)seq.size() < k) return;
        int64_t start = 0;
        if (!is_ref) {
            // start scan EXCLUDES the final kmer position
            // (graph.py:134-143)
            start = -1;
            for (int64_t i = 0; i + k < (int64_t)seq.size(); i++)
                if (!non_unique.count(seq.substr(i, k))) {
                    start = i;
                    break;
                }
            if (start < 0) return;
        }
        sv kmer0 = seq.substr(start, k);
        Vertex* v = get_or_create(kmer0);
        // backward support propagation (graph.py:152-159)
        {
            Vertex* cur = v;
            int off = k - 2;
            while (off >= 0 && cur->in_degree() == 1) {
                Vertex* prev = cur->in_e[0].first;
                Edge* edge = cur->in_e[0].second;
                if (prev->kmer.back() != kmer0[off]) break;
                edge->mult += 1;
                cur = prev;
                off -= 1;
            }
        }
        if (is_ref) ref_source = v;
        for (int64_t i = start + 1; i + k <= (int64_t)seq.size(); i++) {
            char nb = seq[i + k - 1];
            Vertex* target = nullptr;
            Edge* e = nullptr;
            for (auto& p : v->out_e)
                if (p.first->kmer.back() == nb) {
                    target = p.first;
                    e = p.second;
                    break;
                }
            if (!target) {
                sv kmer = seq.substr(i, k);
                if (!is_ref && ref_source && kmer == ref_source->kmer) {
                    // never merge a read path back into the ref SOURCE
                    target = new_vertex(kmer, false);
                } else {
                    target = get_or_create(kmer);
                }
                e = link(v, target, 0, false);
            }
            e->mult += 1;
            e->is_ref |= is_ref;
            v = target;
        }
        if (is_ref) ref_sink = v;
    }

    void remove_dead() {
        for (Vertex* v : vertices) {
            if (!v->dead) continue;
            for (auto& p : v->in_e) p.first->drop_out(v);
            for (auto& p : v->out_e) p.first->drop_in(v);
        }
        std::vector<Vertex*> alive;
        alive.reserve(vertices.size());
        for (Vertex* v : vertices)
            if (!v->dead) alive.push_back(v);
        vertices.swap(alive);
        // drop map entries whose VALUE died (graph.py:201-202); keying by
        // kmer would wrongly evict live vertices sharing a dead clone's kmer
        for (auto it = unique_vertex.begin(); it != unique_vertex.end();)
            it = it->second->dead ? unique_vertex.erase(it) : std::next(it);
    }

    void remove_singleton_orphans() {
        bool any = false;
        for (Vertex* v : vertices)
            if (v->in_degree() == 0 && v->out_degree() == 0 &&
                v != ref_source) {
                v->dead = true;
                any = true;
            }
        if (any) remove_dead();
    }

    bool has_cycle() {
        for (Vertex* v : vertices) v->color = 0;
        std::vector<std::pair<Vertex*, size_t>> stack;
        for (Vertex* root : vertices) {
            if (root->color != 0) continue;
            stack.clear();
            stack.emplace_back(root, 0);
            root->color = 1;
            while (!stack.empty()) {
                auto& [v, idx] = stack.back();
                if (idx >= v->out_e.size()) {
                    v->color = 2;
                    stack.pop_back();
                    continue;
                }
                Vertex* w = v->out_e[idx++].first;
                if (w->color == 1) return true;
                if (w->color == 0) {
                    w->color = 1;
                    stack.emplace_back(w, 0);
                }
            }
        }
        return false;
    }

    bool is_low_quality() const {
        return (int64_t)non_unique.size() * kLowQualMul >
               std::max<int64_t>(1, (int64_t)vertices.size());
    }

    int prune_low_weight_chains() {
        std::vector<Vertex*> chain_starts;
        std::unordered_set<Vertex*> seen_starts;
        for (Vertex* v : vertices)
            if (v->in_degree() == 0 && v->out_degree()) {
                chain_starts.push_back(v);
                seen_starts.insert(v);
            }
        struct Hop {
            Vertex *a, *b;
            Edge* e;
        };
        std::vector<std::vector<Hop>> chains;
        size_t qi = 0;
        while (qi < chain_starts.size()) {
            Vertex* u = chain_starts[qi++];
            for (auto& p0 : u->out_e) {
                std::vector<Hop> chain{{u, p0.first, p0.second}};
                Vertex* last = p0.first;
                while (last->out_degree() == 1 && last->in_degree() <= 1 &&
                       last != u) {
                    auto& p = last->out_e[0];
                    chain.push_back({last, p.first, p.second});
                    last = p.first;
                }
                chains.push_back(std::move(chain));
                if (!seen_starts.count(last)) {
                    seen_starts.insert(last);
                    chain_starts.push_back(last);
                }
            }
        }
        int removed = 0;
        for (auto& chain : chains) {
            bool removable = true;
            for (auto& h : chain)
                if (h.e->mult >= kPruneFactor || h.e->is_ref) {
                    removable = false;
                    break;
                }
            if (!removable) continue;
            for (auto& h : chain)
                if (h.a->find_out(h.b) == h.e) {
                    h.a->drop_out(h.b);
                    h.b->drop_in(h.a);
                }
            removed++;
        }
        remove_singleton_orphans();
        return removed;
    }

    void reach(Vertex* start, bool forward,
               std::unordered_set<Vertex*>& seen) {
        if (!start) return;
        std::vector<Vertex*> stack{start};
        while (!stack.empty()) {
            Vertex* v = stack.back();
            stack.pop_back();
            if (!seen.insert(v).second) continue;
            auto& edges = forward ? v->out_e : v->in_e;
            for (auto& p : edges)
                if (!seen.count(p.first)) stack.push_back(p.first);
        }
    }

    void remove_paths_not_connected_to_ref() {
        std::unordered_set<Vertex*> fwd, bwd;
        reach(ref_source, true, fwd);
        reach(ref_sink, false, bwd);
        bool any = false;
        for (Vertex* v : vertices)
            if (!fwd.count(v) || !bwd.count(v)) {
                v->dead = true;
                any = true;
            }
        if (any) remove_dead();
    }

    // --- dangling-end recovery (graph.py:303-615) ---
    static bool has_ref_out_edge(Vertex* v) {
        if (!v) return false;
        for (auto& p : v->out_e)
            if (p.second->is_ref) return true;
        return false;
    }

    std::string path_bases(const std::vector<Vertex*>& path) const {
        std::string out;
        for (Vertex* v : path) out.push_back(v->kmer.back());
        return out;
    }

    bool find_path_upwards_to_lca(Vertex* vertex,
                                  std::vector<Vertex*>& path) {
        path.clear();
        std::unordered_set<Vertex*> visited;
        Vertex* v = vertex;
        while (v && v->in_degree() == 1 && v->out_degree() < 2) {
            Vertex* parent = v->in_e[0].first;
            Edge* edge = v->in_e[0].second;
            if (edge->mult < kPruneFactor)
                path.clear();
            else
                path.insert(path.begin(), v);
            v = parent;
            if (visited.count(v)) return false;
            visited.insert(v);
        }
        if (v) path.insert(path.begin(), v);
        return v && v->out_degree() > 1;
    }

    static Edge* heaviest_incoming_edge(Vertex* v) {
        Edge* best = nullptr;
        for (auto& p : v->in_e) {
            if (p.second->mult == 1) continue;
            if (!best || p.second->mult > best->mult) best = p.second;
        }
        return best;
    }

    bool reference_path_downward(Vertex* start, Edge* blacklisted,
                                 std::vector<Vertex*>& path) {
        path.clear();
        path.push_back(start);
        std::unordered_set<Vertex*> seen{start};
        Vertex* v = start;
        while (true) {
            Vertex* nxt = nullptr;
            for (auto& p : v->out_e)
                if (p.second->is_ref) {
                    nxt = p.first;
                    break;
                }
            if (!nxt) {
                Vertex* cand = nullptr;
                int n = 0;
                for (auto& p : v->out_e)
                    if (p.second != blacklisted) {
                        cand = p.first;
                        n++;
                    }
                nxt = (n == 1) ? cand : nullptr;
            }
            if (!nxt) break;
            if (seen.count(nxt)) return false;  // cycle
            path.push_back(nxt);
            seen.insert(nxt);
            v = nxt;
        }
        return true;
    }

    void reference_path_from(Vertex* start, bool forward,
                             std::vector<Vertex*>& path) {
        path.clear();
        path.push_back(start);
        std::unordered_set<Vertex*> seen{start};
        Vertex* v = start;
        while (true) {
            Vertex* nxt = nullptr;
            auto& edges = forward ? v->out_e : v->in_e;
            for (auto& p : edges)
                if (p.second->is_ref) {
                    nxt = p.first;
                    break;
                }
            if (!nxt || seen.count(nxt)) break;
            path.push_back(nxt);
            seen.insert(nxt);
            v = nxt;
        }
    }

    static int longest_suffix_match(const std::string& ref_seq,
                                    const std::string& alt_seq,
                                    int64_t ref_end_index) {
        int n = 0;
        int64_t i = ref_end_index, j = (int64_t)alt_seq.size() - 1;
        while (i >= 0 && j >= 0 && ref_seq[i] == alt_seq[j]) {
            n++;
            i--;
            j--;
        }
        return n;
    }

    struct CigEl {
        uint8_t op;
        int32_t len;
    };

    static bool dangling_sw(const std::string& ref_seq,
                            const std::string& alt_seq,
                            std::vector<CigEl>& elems) {
        if (ref_seq.empty() || alt_seq.empty()) return false;
        uint8_t ops[64];
        int32_t lens[64];
        int32_t offset = 0;
        int n = rovaca_sw_align(
            (const uint8_t*)ref_seq.data(), (int)ref_seq.size(),
            (const uint8_t*)alt_seq.data(), (int)alt_seq.size(),
            kDanglingMatch, kDanglingMismatch, kDanglingOpen,
            kDanglingExtend, kLeadingIndel, ops, lens, 64, &offset);
        if (n < 0) return false;
        elems.clear();
        for (int i = 0; i < n; i++) elems.push_back({ops[i], lens[i]});
        return true;
    }

    int recover_dangling_tails() {
        int recovered = 0;
        std::vector<Vertex*> snapshot = vertices;
        std::vector<Vertex*> path, ref_path;
        std::vector<CigEl> elems;
        for (Vertex* v : snapshot) {
            if (v->dead || v->out_degree() != 0 || v == ref_sink) continue;
            if (!find_path_upwards_to_lca(v, path)) continue;
            if ((int)path.size() < kMinDanglingBranchLength + 1 ||
                path[0] == ref_source)
                continue;
            Vertex* lca = path[0];
            Edge* blacklisted =
                path.size() > 1 ? heaviest_incoming_edge(path[1]) : nullptr;
            if (!reference_path_downward(lca, blacklisted, ref_path))
                continue;
            if (ref_path.size() < 2) continue;
            std::string alt_seq = path_bases(path);
            std::string ref_seq = path_bases(ref_path);
            if (!dangling_sw(ref_seq, alt_seq, elems)) continue;
            while (!elems.empty() && elems.back().op == OP_D)
                elems.pop_back();
            if (elems.empty() || (int)elems.size() > kMaxCigarComplexity)
                continue;
            if (elems.back().op != OP_M) continue;
            int64_t last_ref_index = -1;
            for (auto& e : elems)
                if (e.op == OP_M || e.op == OP_D) last_ref_index += e.len;
            int matching_suffix = std::min<int64_t>(
                longest_suffix_match(ref_seq, alt_seq, last_ref_index),
                elems.back().len);
            if (matching_suffix == 0) continue;
            int64_t cigar_read_len = 0;
            for (auto& e : elems)
                if (e.op == OP_M || e.op == OP_I) cigar_read_len += e.len;
            int64_t alt_index =
                std::max<int64_t>(cigar_read_len - matching_suffix - 1, 0);
            bool leading_del =
                elems[0].op == OP_D &&
                elems[0].len + matching_suffix == last_ref_index + 1;
            int64_t ref_index = last_ref_index - matching_suffix + 1 +
                                (leading_del ? 1 : 0);
            if (ref_index == 0 || ref_index >= (int64_t)ref_path.size() ||
                alt_index >= (int64_t)path.size())
                continue;
            Vertex* alt_v = path[alt_index];
            Vertex* ref_v = ref_path[ref_index];
            if (!alt_v->find_out(ref_v)) {
                link(alt_v, ref_v, 1, false);
                recovered++;
            }
        }
        return recovered;
    }

    int recover_dangling_heads() {
        int recovered = 0;
        std::vector<Vertex*> snapshot = vertices;
        std::vector<Vertex*> path, ref_path, alt_path;
        std::vector<CigEl> elems;
        for (Vertex* v : snapshot) {
            if (v->dead || v->in_degree() != 0 || v == ref_source) continue;
            path.clear();
            Vertex* w = v;
            bool ok = true;
            std::unordered_set<Vertex*> visited{v};
            while (w && w->out_degree() &&
                   !(has_ref_out_edge(w) || w->out_degree() != 1)) {
                Vertex* nxt = w->out_e[0].first;
                Edge* edge = w->out_e[0].second;
                if (edge->mult < kPruneFactor)
                    path.clear();
                else
                    path.push_back(w);
                w = nxt;
                if (visited.count(w)) {
                    ok = false;
                    break;
                }
                visited.insert(w);
            }
            if (w) path.push_back(w);
            if (!ok || !has_ref_out_edge(w)) continue;
            if ((int)path.size() < kMinDanglingBranchLength + 1) continue;
            Vertex* hcd = path.back();
            if (hcd == ref_sink) continue;
            alt_path.assign(path.rbegin(), path.rend());  // [HCD..head]
            reference_path_from(hcd, false, ref_path);
            if (ref_path.size() < 2) continue;
            auto rev_bases = [](const std::vector<Vertex*>& p) {
                std::string out;
                for (Vertex* v2 : p) {
                    if (v2->in_degree() == 0) {
                        for (auto it = v2->kmer.rbegin();
                             it != v2->kmer.rend(); ++it)
                            out.push_back(*it);
                    } else {
                        out.push_back(v2->kmer.back());
                    }
                }
                return out;
            };
            std::string alt_seq = rev_bases(alt_path);
            std::string ref_seq = rev_bases(ref_path);
            if (!dangling_sw(ref_seq, alt_seq, elems)) continue;
            if (elems.empty() || (int)elems.size() > kMaxCigarComplexity ||
                elems[0].op != OP_M)
                continue;
            int64_t max_index =
                std::min<int64_t>(elems[0].len,
                                  std::min(ref_seq.size(), alt_seq.size()));
            // budget divides the prefix length considered (maxIndex),
            // not the branch vertex count (hc_assemble_base_graph.c:
            // 704-707,829) -- see assembly/graph.py recover_dangling_heads
            int64_t max_mismatches = std::max<int64_t>(1, max_index / k);
            int64_t mismatches = 0;
            int64_t last_good = -1;
            for (int64_t idx = 0; idx < max_index; idx++) {
                if (ref_seq[idx] != alt_seq[idx]) {
                    mismatches++;
                    if (mismatches > max_mismatches) {
                        last_good = -1;
                        break;
                    }
                    last_good = idx;
                }
            }
            int64_t indexes_to_merge = last_good;
            if (indexes_to_merge <= 0) continue;
            if (indexes_to_merge >= (int64_t)ref_path.size() - 1) continue;
            if (indexes_to_merge >= (int64_t)alt_path.size()) {
                if (!extend_dangling_path(
                        alt_path, ref_path, elems,
                        indexes_to_merge - (int64_t)alt_path.size() + 2))
                    continue;
            }
            Vertex* from_v = ref_path[indexes_to_merge + 1];
            Vertex* to_v = alt_path[indexes_to_merge];
            if (!from_v->find_out(to_v)) {
                link(from_v, to_v, 1, false);
                recovered++;
            }
        }
        return recovered;
    }

    bool extend_dangling_path(std::vector<Vertex*>& alt_path,
                              const std::vector<Vertex*>& ref_path,
                              const std::vector<CigEl>& cigar,
                              int64_t n_extend) {
        int64_t ref_len = 0, read_len = 0;
        for (auto& e : cigar) {
            if (e.op == OP_M || e.op == OP_D) ref_len += e.len;
            if (e.op == OP_M || e.op == OP_I) read_len += e.len;
        }
        int64_t offset = ref_len - read_len;
        int64_t index_of_ref_node =
            (int64_t)alt_path.size() - 1 + offset + n_extend;
        if (index_of_ref_node < 0 ||
            index_of_ref_node >= (int64_t)ref_path.size())
            return false;
        Vertex* dangling_source = alt_path.back();
        alt_path.pop_back();
        Vertex* ref_v = ref_path[index_of_ref_node];
        kmer_store.emplace_back();
        std::string& seq = kmer_store.back();
        seq.assign(ref_v->kmer.substr(0, n_extend));
        seq.append(dangling_source->kmer);
        if (dangling_source->out_e.empty()) return false;
        Vertex* prev_v = dangling_source->out_e[0].first;
        Edge* source_edge = dangling_source->out_e[0].second;
        int64_t weight = source_edge->mult;
        dangling_source->drop_out(prev_v);
        prev_v->drop_in(dangling_source);
        for (int64_t i = n_extend; i > 0; i--) {
            sv kmer = sv(seq).substr(i, k);
            Vertex* new_v = new_vertex(kmer, false);
            link(new_v, prev_v, weight, false);
            alt_path.push_back(new_v);
            prev_v = new_v;
        }
        return true;
    }
};

// ---------------------------------------------------------------- Seq graph
struct SeqVertex {
    std::string seq;
    std::vector<std::pair<SeqVertex*, Edge*>> in_e, out_e;
    bool dead = false;

    Edge* find_out(SeqVertex* w) const {
        for (auto& p : out_e)
            if (p.first == w) return p.second;
        return nullptr;
    }
    void drop_out(SeqVertex* w) {
        for (size_t i = 0; i < out_e.size(); i++)
            if (out_e[i].first == w) {
                out_e.erase(out_e.begin() + i);
                return;
            }
    }
    void drop_in(SeqVertex* u) {
        for (size_t i = 0; i < in_e.size(); i++)
            if (in_e[i].first == u) {
                in_e.erase(in_e.begin() + i);
                return;
            }
    }
    int in_degree() const { return (int)in_e.size(); }
    int out_degree() const { return (int)out_e.size(); }
};

struct SeqGraph {
    std::deque<SeqVertex> pool;
    std::deque<Edge> edge_pool;
    std::vector<SeqVertex*> vertices;
    SeqVertex* ref_source = nullptr;
    SeqVertex* ref_sink = nullptr;

    SeqVertex* add_vertex(std::string seq) {
        pool.push_back(SeqVertex{});
        SeqVertex* v = &pool.back();
        v->seq = std::move(seq);
        vertices.push_back(v);
        return v;
    }

    Edge* link(SeqVertex* u, SeqVertex* v, int64_t mult, bool is_ref) {
        edge_pool.push_back(Edge{mult, is_ref});
        Edge* e = &edge_pool.back();
        u->out_e.emplace_back(v, e);
        v->in_e.emplace_back(u, e);
        return e;
    }

    Edge* add_edge(SeqVertex* u, SeqVertex* v, int64_t mult, bool is_ref) {
        Edge* e = u->find_out(v);
        if (!e) return link(u, v, mult, is_ref);
        e->mult += mult;
        e->is_ref |= is_ref;
        return e;
    }

    void remove_batch(const std::vector<SeqVertex*>& dead) {
        for (SeqVertex* v : dead) v->dead = true;
        for (SeqVertex* v : dead) {
            for (auto& p : v->in_e) p.first->drop_out(v);
            for (auto& p : v->out_e) p.first->drop_in(v);
        }
        std::vector<SeqVertex*> alive;
        alive.reserve(vertices.size());
        for (SeqVertex* v : vertices)
            if (!v->dead) alive.push_back(v);
        vertices.swap(alive);
    }

    void remove_singleton_orphans() {
        std::vector<SeqVertex*> dead;
        for (SeqVertex* v : vertices)
            if (v->in_degree() == 0 && v->out_degree() == 0 &&
                v != ref_source)
                dead.push_back(v);
        if (!dead.empty()) remove_batch(dead);
    }

    void remove_not_connected_undirected() {
        if (!ref_source) return;
        std::unordered_set<SeqVertex*> seen;
        std::vector<SeqVertex*> stack{ref_source};
        while (!stack.empty()) {
            SeqVertex* v = stack.back();
            stack.pop_back();
            if (!seen.insert(v).second) continue;
            for (auto& p : v->in_e)
                if (!seen.count(p.first)) stack.push_back(p.first);
            for (auto& p : v->out_e)
                if (!seen.count(p.first)) stack.push_back(p.first);
        }
        std::vector<SeqVertex*> dead;
        for (SeqVertex* v : vertices)
            if (!seen.count(v)) dead.push_back(v);
        if (!dead.empty()) remove_batch(dead);
    }

    // --- zip (graph.py zip_linear_chains, reference-exact) ---
    static bool is_ref_node(SeqVertex* v) {
        for (auto& p : v->out_e)
            if (p.second->is_ref) return true;
        return false;
    }

    bool is_linear_chain_start(SeqVertex* v) const {
        if (v->out_degree() != 1) return false;
        if (v->in_degree() != 1) return true;
        return v->in_e[0].first->out_degree() > 1;
    }

    void trace_linear_chain(SeqVertex* zip_start,
                            std::vector<SeqVertex*>& chain) {
        chain.clear();
        chain.push_back(zip_start);
        SeqVertex* last = zip_start;
        bool last_is_ref = is_ref_node(last);
        while (last->out_degree() == 1) {
            SeqVertex* target = last->out_e[0].first;
            if (target->in_degree() != 1 || target == last) break;
            bool target_is_ref = is_ref_node(target);
            if (last_is_ref != target_is_ref) break;
            chain.push_back(target);
            last = target;
            last_is_ref = target_is_ref;
        }
    }

    bool merge_linear_chain(std::vector<SeqVertex*>& chain) {
        if (chain.size() < 2) return false;
        std::string seq;
        for (SeqVertex* v : chain) seq += v->seq;
        SeqVertex* merged = add_vertex(std::move(seq));
        SeqVertex* first = chain.front();
        SeqVertex* last = chain.back();
        for (auto& p : last->out_e) {
            p.first->drop_in(last);
            merged->out_e.push_back(p);
            p.first->in_e.emplace_back(merged, p.second);
        }
        last->out_e.clear();
        for (auto& p : first->in_e) {
            p.first->drop_out(first);
            merged->in_e.push_back(p);
            p.first->out_e.emplace_back(merged, p.second);
        }
        first->in_e.clear();
        for (SeqVertex* v : chain) {
            if (v == ref_source) ref_source = merged;
            if (v == ref_sink) ref_sink = merged;
        }
        remove_batch(chain);
        return true;
    }

    bool zip_linear_chains() {
        std::vector<SeqVertex*> zip_starts;
        for (SeqVertex* v : vertices)
            if (is_linear_chain_start(v)) zip_starts.push_back(v);
        bool merged_one = false;
        std::vector<SeqVertex*> chain;
        for (SeqVertex* zs : zip_starts) {
            trace_linear_chain(zs, chain);
            merged_one |= merge_linear_chain(chain);
        }
        return merged_one;
    }

    // --- splitter ops (graph.py ports of
    //     hc_assemble_vertex_sequence_spliter.c) ---
    static bool is_ref_source_vertex(SeqVertex* v) {
        for (auto& p : v->in_e)
            if (p.second->is_ref) return false;
        for (auto& p : v->out_e)
            if (p.second->is_ref) return true;
        return false;
    }

    static bool is_ref_sink_vertex(SeqVertex* v) {
        for (auto& p : v->out_e)
            if (p.second->is_ref) return false;
        for (auto& p : v->in_e)
            if (p.second->is_ref) return true;
        return false;
    }

    void rederive_ref_endpoints() {
        ref_source = nullptr;
        ref_sink = nullptr;
        for (SeqVertex* v : vertices)
            if (is_ref_source_vertex(v)) {
                ref_source = v;
                break;
            }
        for (SeqVertex* v : vertices)
            if (is_ref_sink_vertex(v)) {
                ref_sink = v;
                break;
            }
    }

    static void common_prefix_suffix_len(
        const std::vector<SeqVertex*>& middles, int64_t& pre,
        int64_t& suf) {
        int64_t min_len = INT64_MAX;
        for (SeqVertex* m : middles)
            min_len = std::min<int64_t>(min_len, m->seq.size());
        const std::string& first = middles[0]->seq;
        pre = 0;
        while (pre < min_len) {
            bool all = true;
            for (size_t i = 1; i < middles.size(); i++)
                if (middles[i]->seq[pre] != first[pre]) {
                    all = false;
                    break;
                }
            if (!all) break;
            pre++;
        }
        int64_t lim = min_len - pre;
        suf = 0;
        while (suf < lim) {
            bool all = true;
            char c = first[first.size() - 1 - suf];
            for (size_t i = 1; i < middles.size(); i++) {
                const std::string& s = middles[i]->seq;
                if (s[s.size() - 1 - suf] != c) {
                    all = false;
                    break;
                }
            }
            if (!all) break;
            suf++;
        }
    }

    bool try_merge_diamond(SeqVertex* top) {
        if (top->out_degree() <= 1) return false;
        std::vector<SeqVertex*> middles;
        for (auto& p : top->out_e) middles.push_back(p.first);
        SeqVertex* bottom = nullptr;
        for (SeqVertex* mi : middles) {
            if (mi->out_degree() < 1 || mi->in_degree() != 1) return false;
            for (auto& p : mi->out_e) {
                if (!bottom)
                    bottom = p.first;
                else if (bottom != p.first)
                    return false;
            }
        }
        if (bottom->in_degree() != (int)middles.size()) return false;
        int64_t pre, suf;
        common_prefix_suffix_len(middles, pre, suf);
        if (pre < 1 && suf < 1) return false;
        split_and_update(middles, top, bottom, pre, suf);
        return true;
    }

    void split_and_update(const std::vector<SeqVertex*>& middles,
                          SeqVertex* top, SeqVertex* bottom, int64_t pre,
                          int64_t suf) {
        const std::string& first = middles[0]->seq;
        std::string prefix_seq = first.substr(0, pre);
        std::string suffix_seq =
            suf ? first.substr(first.size() - suf) : std::string();
        // split graph (fresh, unregistered vertices)
        std::deque<SeqVertex> sp_pool;
        std::deque<Edge> sp_edges;
        sp_pool.push_back(SeqVertex{});
        SeqVertex* prefix_sv = &sp_pool.back();
        prefix_sv->seq = prefix_seq;
        sp_pool.push_back(SeqVertex{});
        SeqVertex* suffix_sv = &sp_pool.back();
        suffix_sv->seq = suffix_seq;
        auto sp_link = [&](SeqVertex* u, SeqVertex* w, int64_t m, bool r) {
            sp_edges.push_back(Edge{m, r});
            Edge* e = &sp_edges.back();
            u->out_e.emplace_back(w, e);
            w->in_e.emplace_back(u, e);
            return e;
        };
        std::vector<std::pair<SeqVertex*, SeqVertex*>> mapping;  // split,outer
        for (SeqVertex* mid : middles) {
            Edge* e_to = mid->in_e[0].second;
            Edge* e_from = mid->out_e[0].second;
            std::string rem =
                mid->seq.substr(pre, mid->seq.size() - suf - pre);
            if (!rem.empty()) {
                sp_pool.push_back(SeqVertex{});
                SeqVertex* rv = &sp_pool.back();
                rv->seq = std::move(rem);
                mapping.emplace_back(rv, nullptr);
                sp_link(prefix_sv, rv, e_to->mult, e_to->is_ref);
                sp_link(rv, suffix_sv, e_from->mult, e_from->is_ref);
            } else {
                int64_t w = e_to->mult + e_from->mult;
                bool r = e_to->is_ref || e_from->is_ref;
                Edge* e = prefix_sv->find_out(suffix_sv);
                if (!e)
                    sp_link(prefix_sv, suffix_sv, w, r);
                else {
                    e->mult += w;
                    e->is_ref |= r;
                }
            }
        }

        remove_batch(middles);
        for (auto& m : mapping) m.second = add_vertex(m.first->seq);

        bool has_ps = prefix_sv->find_out(suffix_sv) != nullptr;
        bool has_only_ps = has_ps && prefix_sv->out_degree() == 1;
        bool need_prefix = pre > 0 || (!top && !has_only_ps);
        bool need_suffix = suf > 0 || (!bottom && !has_only_ps);
        SeqVertex *top_for, *bot_for;
        if (need_prefix) {
            SeqVertex* pv_main = add_vertex(prefix_seq);
            if (top) {
                bool is_ref = false;
                for (auto& p : prefix_sv->out_e) is_ref |= p.second->is_ref;
                link(top, pv_main, 1, is_ref);
            }
            top_for = pv_main;
        } else {
            top_for = top;
        }
        if (need_suffix) {
            SeqVertex* sv_main = add_vertex(suffix_seq);
            if (bottom) {
                bool is_ref = false;
                for (auto& p : suffix_sv->in_e) is_ref |= p.second->is_ref;
                link(sv_main, bottom, 1, is_ref);
            }
            bot_for = sv_main;
        } else {
            bot_for = bottom;
        }
        if (top_for) {
            for (auto& p : prefix_sv->out_e) {
                if (p.first == suffix_sv) {
                    if (!bot_for || top_for->find_out(bot_for)) continue;
                    link(top_for, bot_for, p.second->mult,
                         p.second->is_ref);
                } else {
                    SeqVertex* ov = nullptr;
                    for (auto& m : mapping)
                        if (m.first == p.first) {
                            ov = m.second;
                            break;
                        }
                    if (!ov || top_for->find_out(ov)) continue;
                    link(top_for, ov, p.second->mult, p.second->is_ref);
                }
            }
        }
        if (bot_for) {
            for (auto& p : suffix_sv->in_e) {
                SeqVertex* ov = nullptr;
                for (auto& m : mapping)
                    if (m.first == p.first) {
                        ov = m.second;
                        break;
                    }
                if (!ov) continue;  // the prefix vertex
                if (ov->find_out(bot_for)) continue;
                link(ov, bot_for, p.second->mult, p.second->is_ref);
            }
        }
    }

    bool try_split_common_suffix(SeqVertex* bottom,
                                 std::unordered_set<SeqVertex*>& already) {
        if (!already.insert(bottom).second) return false;
        if (bottom->in_degree() < 2) return false;
        std::vector<SeqVertex*> to_split;
        for (auto& p : bottom->in_e) to_split.push_back(p.first);
        for (SeqVertex* m : to_split) {
            if (m == bottom || m->out_degree() != 1 || !m->find_out(bottom))
                return false;
            if (bottom->find_out(m)) return false;
        }
        int64_t min_len = INT64_MAX;
        for (SeqVertex* m : to_split)
            min_len = std::min<int64_t>(min_len, m->seq.size());
        const std::string& first = to_split[0]->seq;
        int64_t suf = 0;
        while (suf < min_len) {
            bool all = true;
            char c = first[first.size() - 1 - suf];
            for (size_t i = 1; i < to_split.size(); i++) {
                const std::string& s = to_split[i]->seq;
                if (s[s.size() - 1 - suf] != c) {
                    all = false;
                    break;
                }
            }
            if (!all) break;
            suf++;
        }
        if (suf == 0) return false;
        for (SeqVertex* m : to_split) {
            if (is_ref_source_vertex(m)) {
                if ((int64_t)m->seq.size() == suf) return false;
                break;
            }
        }
        bool all_suffix = true;
        for (SeqVertex* m : to_split)
            if ((int64_t)m->seq.size() != suf) {
                all_suffix = false;
                break;
            }
        if (all_suffix) return false;
        std::string suffix_seq = first.substr(first.size() - suf);
        for (SeqVertex* mid : to_split) {
            Edge* out_e = mid->out_e[0].second;
            SeqVertex* out_target = mid->out_e[0].first;
            SeqVertex* suffix_v = add_vertex(suffix_seq);
            std::string prefix_seq = mid->seq.substr(0, mid->seq.size() - suf);
            SeqVertex* incoming_target;
            if (prefix_seq.empty()) {
                incoming_target = suffix_v;
            } else {
                incoming_target = add_vertex(std::move(prefix_seq));
                link(incoming_target, suffix_v, 1, out_e->is_ref);
            }
            link(suffix_v, out_target, 1, out_e->is_ref);
            for (auto& p : mid->in_e)
                link(p.first, incoming_target, p.second->mult,
                     p.second->is_ref);
        }
        remove_batch(to_split);
        return true;
    }

    bool try_merge_common_suffix(SeqVertex* v) {
        if (v->in_e.empty()) return false;
        std::vector<SeqVertex*> prevs;
        for (auto& p : v->in_e) prevs.push_back(p.first);
        SeqVertex* first = prevs[0];
        for (SeqVertex* p : prevs) {
            if (p->seq != first->seq || p->out_degree() != 1) return false;
            if (p->out_e[0].first != v) return false;
            if (p->in_degree() == 0) return false;
        }
        SeqVertex* new_v = add_vertex(first->seq + v->seq);
        for (SeqVertex* p : prevs)
            for (auto& pe : p->in_e)
                if (!pe.first->find_out(new_v))
                    link(pe.first, new_v, pe.second->mult, pe.second->is_ref);
        for (auto& pe : v->out_e)
            if (!new_v->find_out(pe.first))
                link(new_v, pe.first, pe.second->mult, pe.second->is_ref);
        std::vector<SeqVertex*> dead(prevs);
        dead.push_back(v);
        remove_batch(dead);
        return true;
    }

    template <typename F>
    bool run_to_fixed_point(F try_fn) {
        bool did_any = false;
        bool found = true;
        while (found) {
            found = false;
            std::vector<SeqVertex*> snapshot = vertices;
            for (SeqVertex* v : snapshot) {
                if (v->dead) continue;
                if (try_fn(v)) {
                    found = true;
                    did_any = true;
                    break;
                }
            }
        }
        return did_any;
    }

    using Snapshot = std::pair<std::vector<std::string>,
                               std::vector<std::tuple<std::string,
                                                      std::string, int64_t,
                                                      bool>>>;
    Snapshot snapshot() const {
        Snapshot s;
        for (SeqVertex* v : vertices) s.first.push_back(v->seq);
        std::sort(s.first.begin(), s.first.end());
        for (SeqVertex* v : vertices)
            for (auto& p : v->out_e)
                s.second.emplace_back(v->seq, p.first->seq, p.second->mult,
                                      p.second->is_ref);
        std::sort(s.second.begin(), s.second.end());
        return s;
    }

    void simplify() {
        zip_linear_chains();
        bool have_prev = false;
        Snapshot prev;
        for (int i = 0; i < 100; i++) {
            bool changed = run_to_fixed_point(
                [this](SeqVertex* v) { return try_merge_diamond(v); });
            {
                std::unordered_set<SeqVertex*> already;
                changed |= run_to_fixed_point([this, &already](SeqVertex* v) {
                    return try_split_common_suffix(v, already);
                });
            }
            changed |= run_to_fixed_point(
                [this](SeqVertex* v) { return try_merge_common_suffix(v); });
            changed |= zip_linear_chains();
            if (!changed) break;
            if (i > 5) {
                Snapshot snap = snapshot();
                if (have_prev && snap == prev) break;
                prev = std::move(snap);
                have_prev = true;
            }
        }
    }
};

// ------------------------------------------------------------- K-best paths
struct PathResult {
    std::string seq;
    double score;
    bool is_ref;
};

std::string invkey(const std::string& seq) {
    std::string out;
    out.reserve(seq.size() + 1);
    for (unsigned char c : seq) out.push_back((char)(unsigned char)(255 - c));
    out.push_back((char)0xff);
    return out;
}

struct HeapItem {
    double neg_score;
    std::string inv;
    int64_t counter;  // increments; larger pops first among exact ties
    std::string seq;
    SeqVertex* v;
    bool is_ref;
};

struct HeapCmp {
    // std::set ordered ascending = Python heap pop order
    bool operator()(const HeapItem& a, const HeapItem& b) const {
        if (a.neg_score != b.neg_score) return a.neg_score < b.neg_score;
        int c = a.inv.compare(b.inv);
        if (c != 0) return c < 0;
        return a.counter > b.counter;  // newest first (graph.py:955-958)
    }
};

void find_k_best_haplotypes(SeqGraph& g, int results_start,
                            std::vector<PathResult>& results) {
    results.clear();
    SeqVertex *source = g.ref_source, *sink = g.ref_sink;
    if (!source || !sink) return;
    std::unordered_map<SeqVertex*, int> visit_count;
    std::multiset<HeapItem, HeapCmp> heap;
    int64_t counter = 0;
    heap.insert(HeapItem{0.0, invkey(source->seq), counter++, source->seq,
                         source, true});
    while (!heap.empty() &&
           results_start + (int)results.size() <= kMaxHaplotypes) {
        HeapItem it = *heap.begin();
        heap.erase(heap.begin());
        if (it.v == sink) {
            results.push_back({std::move(it.seq), -it.neg_score, it.is_ref});
            continue;
        }
        int& visits = visit_count[it.v];
        if (visits + 1 >= kMaxHaplotypes) continue;
        visits += 1;
        int64_t total_out = 0;
        for (auto& p : it.v->out_e) total_out += p.second->mult;
        if (total_out == 0) continue;
        for (auto& p : it.v->out_e) {
            double penalty = std::log10((double)p.second->mult) -
                             std::log10((double)total_out);
            std::string nseq = it.seq + p.first->seq;
            heap.insert(HeapItem{it.neg_score - penalty, invkey(nseq),
                                 counter++, std::move(nseq), p.first,
                                 it.is_ref && p.second->is_ref});
        }
    }
}

// ------------------------------------------------------------ region driver
struct KmerResult {
    std::vector<PathResult> paths;
    bool build_ok = false;   // paths valid (possibly empty)
    bool ran_kbest = false;
};

void split_usable(const uint8_t* bases, const uint8_t* quals, int64_t len,
                  int k, std::vector<sv>& out) {
    int64_t run = 0;
    for (int64_t i = 0; i <= len; i++) {
        bool good = i < len && bases[i] != 'N' && quals[i] >= kMinAssemblyQual;
        if (good) {
            run++;
        } else {
            if (run >= k)
                out.emplace_back((const char*)bases + i - run, run);
            run = 0;
        }
    }
}

void assemble_with_kmer(const uint8_t* ref, int64_t ref_len, int64_t n_reads,
                        const uint8_t* bases, const uint8_t* quals,
                        const int64_t* seq_off, const int32_t* seq_len,
                        int k, bool allow_low_complexity, bool first_kbest,
                        KmerResult& out) {
    out.paths.clear();
    out.build_ok = false;
    out.ran_kbest = false;
    if (ref_len < k) return;
    RTGraph g(k);
    sv refsv((const char*)ref, ref_len);
    if (!allow_low_complexity && g.ref_has_non_unique(refsv)) return;

    std::vector<sv> read_seqs;
    for (int64_t r = 0; r < n_reads; r++)
        split_usable(bases + seq_off[r], quals + seq_off[r], seq_len[r], k,
                     read_seqs);
    {
        ProfScope ps(AsmProf::NONUNIQ);
        std::vector<sv> all;
        all.reserve(read_seqs.size() + 1);
        all.push_back(refsv);
        for (auto& s : read_seqs) all.push_back(s);
        g.determine_non_unique(all);
    }
    {
        ProfScope ps(AsmProf::THREAD);
        g.thread_sequence(refsv, true);
        for (auto& s : read_seqs) g.thread_sequence(s, false);
    }
    {
        ProfScope ps(AsmProf::PRUNE);
        g.prune_low_weight_chains();
        if (g.has_cycle()) return;
        if (!allow_low_complexity && g.is_low_quality()) return;
    }
    {
        ProfScope ps(AsmProf::DANGLING);
        g.recover_dangling_tails();
        g.recover_dangling_heads();
        g.remove_paths_not_connected_to_ref();
    }
    if (!g.ref_source || !g.ref_sink) return;

    SeqGraph sg;
    {
        ProfScope ps_sg(AsmProf::SEQGRAPH);
        {
        std::unordered_map<Vertex*, SeqVertex*> mapping;
        for (Vertex* v : g.vertices) {
            std::string seq = (v == g.ref_source)
                                  ? std::string(v->kmer)
                                  : std::string(1, v->kmer.back());
            mapping[v] = sg.add_vertex(std::move(seq));
        }
        for (Vertex* v : g.vertices)
            for (auto& p : v->out_e)
                sg.add_edge(mapping[v], mapping[p.first], p.second->mult,
                            p.second->is_ref);
        sg.ref_source = g.ref_source ? mapping[g.ref_source] : nullptr;
        sg.ref_sink = g.ref_sink ? mapping[g.ref_sink] : nullptr;
    }
        sg.zip_linear_chains();
        sg.remove_singleton_orphans();
        sg.remove_not_connected_undirected();
        sg.simplify();
        sg.rederive_ref_endpoints();
        if (!sg.ref_source || !sg.ref_sink) return;
        sg.simplify();
        sg.rederive_ref_endpoints();
    }
    out.build_ok = true;
    if (!sg.ref_source) return;  // success, zero paths, dijkstra never ran
    out.ran_kbest = true;
    ProfScope ps_kb(AsmProf::KBEST);
    find_k_best_haplotypes(sg, first_kbest ? 1 : 0, out.paths);
}

}  // namespace

// Whole-region assembly over the kmer ladder. Outputs the merged
// (first-seen-wins) path set in insertion order; the caller sorts and
// aligns. Returns n_out, or -1 if out_buf/max_out capacity was exceeded
// (caller falls back to the Python oracle).
extern "C" int64_t rovaca_assemble_region(
    const uint8_t* ref, int64_t ref_len, int64_t n_reads,
    const uint8_t* bases, const uint8_t* quals, const int64_t* seq_off,
    const int32_t* seq_len, const int32_t* kmer_sizes, int32_t n_kmers,
    int32_t kmer_step, int32_t max_iterations, uint8_t* out_buf,
    int64_t out_cap, int64_t* out_off, double* out_scores,
    int32_t* out_kmers, int64_t max_out) {
    std::vector<std::string> order;
    std::unordered_map<std::string, std::pair<double, int32_t>> results;
    bool any_success = false;
    bool first_kbest = true;
    KmerResult kr;
    auto merge = [&](int kk) {
        for (auto& p : kr.paths) {
            auto it = results.find(p.seq);
            if (it == results.end()) {
                results.emplace(p.seq, std::make_pair(p.score, kk));
                order.push_back(p.seq);
            }
        }
    };
    for (int32_t i = 0; i < n_kmers; i++) {
        int kk = kmer_sizes[i];
        assemble_with_kmer(ref, ref_len, n_reads, bases, quals, seq_off,
                           seq_len, kk, false, first_kbest, kr);
        first_kbest &= !kr.ran_kbest;
        if (!kr.build_ok) continue;
        any_success = true;
        merge(kk);
    }
    if (!any_success) {
        int kk = kmer_sizes[n_kmers - 1];
        int max_kmer = kmer_sizes[n_kmers - 1] + kmer_step * max_iterations;
        for (int32_t it = 0; it < max_iterations; it++) {
            kk += kmer_step;
            assemble_with_kmer(ref, ref_len, n_reads, bases, quals, seq_off,
                               seq_len, kk, kk >= max_kmer, first_kbest, kr);
            first_kbest &= !kr.ran_kbest;
            if (kr.build_ok) {
                merge(kk);
                break;
            }
        }
    }
    if ((int64_t)order.size() > max_out) return -1;
    int64_t pos = 0;
    for (size_t i = 0; i < order.size(); i++) {
        const std::string& seq = order[i];
        if (pos + (int64_t)seq.size() > out_cap) return -1;
        std::memcpy(out_buf + pos, seq.data(), seq.size());
        out_off[i] = pos;
        pos += seq.size();
        auto& pr = results[seq];
        out_scores[i] = pr.first;
        out_kmers[i] = pr.second;
    }
    out_off[order.size()] = pos;
    return (int64_t)order.size();
}

// Fused region prep: finalize + overlap-adjust + full kmer-ladder assembly
// in one call, with the finalized reads flowing straight into the graph
// build (no Python round-trip between the stages). Outputs both the
// finalized read arrays (rovaca_finalize_region layout) and the haplotype
// path arrays (rovaca_assemble_region layout). Returns n_haplotype_paths,
// with *out_n_reads set, or -1 on any capacity overflow.
extern "C" int64_t rovaca_prepare_region(
    // raw region reads
    int64_t n_reads, const uint8_t* names, const int64_t* name_off,
    const int32_t* flag, const int32_t* ref_id, const int64_t* pos,
    const int32_t* tlen, const int64_t* mate_pos, const int64_t* cig_off,
    const int32_t* cig_n, const uint8_t* cig_ops, const int32_t* cig_lens,
    const int64_t* seq_off, const int32_t* seq_len, const uint8_t* bases,
    const uint8_t* quals, const int32_t* hard_left,
    const int32_t* hard_right, int64_t span_start, int64_t span_end,
    // assembly window + kmer ladder
    const uint8_t* ref, int64_t ref_len, const int32_t* kmer_sizes,
    int32_t n_kmers, int32_t kmer_step, int32_t max_iterations,
    // finalized-read outputs
    int32_t* out_idx, int64_t* out_pos, int32_t* out_hard_left,
    int32_t* out_hard_right, int64_t* out_cig_off, int32_t* out_cig_n,
    uint8_t* out_cig_ops, int32_t* out_cig_lens, int64_t out_cig_cap,
    int64_t* out_seq_off, int32_t* out_seq_len, uint8_t* out_bases,
    uint8_t* out_quals, int64_t out_seq_cap, int64_t max_out_reads,
    int64_t* out_n_reads,
    // haplotype outputs
    uint8_t* hap_buf, int64_t hap_cap, int64_t* hap_off,
    double* hap_scores, int32_t* hap_kmers, int64_t max_out_haps) {
    ProfScope* ps_fin = new ProfScope(AsmProf::FIN);
    std::vector<rovaca_fin::FRead> fin = rovaca_fin::finalize_impl(
        n_reads, names, name_off, flag, ref_id, pos, tlen, mate_pos,
        cig_off, cig_n, cig_ops, cig_lens, seq_off, seq_len, bases, quals,
        hard_left, hard_right, span_start, span_end);
    int64_t nf = rovaca_fin::serialize_fin(
        fin, out_idx, out_pos, out_hard_left, out_hard_right, out_cig_off,
        out_cig_n, out_cig_ops, out_cig_lens, out_cig_cap, out_seq_off,
        out_seq_len, out_bases, out_quals, out_seq_cap, max_out_reads);
    delete ps_fin;
    if (nf < 0) return -1;
    *out_n_reads = nf;
    // run the kmer ladder directly over the serialized finalized arrays
    return rovaca_assemble_region(
        ref, ref_len, nf, out_bases, out_quals, out_seq_off, out_seq_len,
        kmer_sizes, n_kmers, kmer_step, max_iterations, hap_buf, hap_cap,
        hap_off, hap_scores, hap_kmers, max_out_haps);
}
