// Native replay-graph topology engine (the port's own copy of the JAX
// package's csrc/tdx_graph.cc; loaded by torchdistx_tpu_torch/_native.py).
//
// Counterpart of the reference torchdistx's C++ OpNode machinery
// (deferred_init.cc:309-705): node creation order (op_nr), output-storage
// alias tracking, dependency / dependent edges, the last-in-place walk and
// call-stack collection.  The Python layer keeps the op closures and
// preserved argument stacks (they are Python objects); this library owns
// the graph *topology* and the hot graph walks, and reproduces the
// reference's ownership semantics: a node's destructor erases its
// back-edges from its dependencies (deferred_init.cc:409-411), driven here
// by the Python wrapper's lifetime via tdx_node_destroy.
//
// A plain C API for ctypes; compiled by the host C++ compiler
// (torchdistx_tpu_torch/ops/_build.py), no CUDA.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#define TDX_BUILDING_DLL
#include "include/tdx_graph.h"  // public C API — keeps signatures in sync

#define TDX_API extern "C" __attribute__((visibility("default")))

namespace {

struct Node {
  uint64_t id = 0;
  uint64_t op_nr = 0;
  bool materialized = false;
  std::vector<uint64_t> storages;
  std::vector<std::pair<uint64_t, int32_t>> deps;  // (node id, output index)
  std::vector<uint64_t> dependents;                // back-edges
};

struct Graph {
  std::unordered_map<uint64_t, Node> nodes;
  uint64_t next_id = 1;
  uint64_t next_op_nr = 0;
  std::mutex mu;

  Node* get(uint64_t id) {
    auto it = nodes.find(id);
    return it == nodes.end() ? nullptr : &it->second;
  }
};

bool storages_intersect(const Node& a, const Node& b) {
  for (uint64_t s : a.storages)
    for (uint64_t t : b.storages)
      if (s == t) return true;
  return false;
}

// Latest node mutating `node`'s storages: walks BOTH dependent and
// dependency edges through storage-aliasing nodes. (The reference walks
// dependents only, deferred_init.cc:537-575, which misses in-place ops
// recorded against a view's base fake; see _graph.py last_in_place_node.)
Node* last_in_place(Graph& g, Node& node) {
  Node* last = &node;
  std::unordered_set<uint64_t> seen{node.id};
  std::vector<uint64_t> stack{node.id};
  while (!stack.empty()) {
    Node* n = g.get(stack.back());
    stack.pop_back();
    if (!n) continue;
    auto consider = [&](uint64_t mid) {
      if (seen.count(mid)) return;
      seen.insert(mid);
      Node* m = g.get(mid);
      if (!m || !storages_intersect(*m, node)) return;
      if (m->op_nr > last->op_nr) last = m;
      stack.push_back(mid);
    };
    for (uint64_t d : n->dependents) consider(d);
    for (auto& [dep_id, idx] : n->deps) consider(dep_id);
  }
  return last;
}

// Port of OpNode.build_call_stack (torchdistx_tpu_torch/_graph.py), which in
// turn mirrors buildCallStack/collectCallStack
// (deferred_init.cc:526-618): dependency closure of the last in-place
// node, plus aliasing dependents up to it, plus clobbered readers, to a
// fixpoint; sorted chronologically.
std::vector<uint64_t> build_call_stack(Graph& g, Node& node) {
  Node* last = last_in_place(g, node);
  std::unordered_map<uint64_t, Node*> included;

  std::vector<Node*> visit_stack;
  auto visit = [&](Node* n) {
    visit_stack.push_back(n);
    while (!visit_stack.empty()) {
      Node* cur = visit_stack.back();
      visit_stack.pop_back();
      if (included.count(cur->id)) continue;
      included.emplace(cur->id, cur);
      for (auto& [dep_id, idx] : cur->deps) {
        Node* dep = g.get(dep_id);
        if (dep && !dep->materialized && !included.count(dep->id))
          visit_stack.push_back(dep);
      }
    }
  };

  visit(&node);
  if (last != &node) visit(last);

  bool changed = true;
  while (changed) {
    changed = false;
    std::vector<Node*> snapshot;
    snapshot.reserve(included.size());
    for (auto& [id, n] : included) snapshot.push_back(n);
    // The alias FRONTIER: included nodes plus the transitive alias
    // closure over them, in BOTH directions.  Materialized nodes are
    // never replayed, but their cached outputs carry the aliasing
    // relation — dependencies reach the storage's base, and materialized
    // aliasing DEPENDENTS reach the rest of the alias web hanging off it
    // (a data-read/in-place chain on the base), whose own non-aliasing
    // readers (clone/deepcopy) are clobbered by an included mutator of
    // the shared storage just the same (mirrors the Python walk; soak
    // fuzzer seeds 1465/1537).
    std::vector<Node*> frontier(snapshot);
    std::unordered_set<uint64_t> fseen;
    for (Node* f : frontier) fseen.insert(f->id);
    for (size_t fi = 0; fi < frontier.size(); ++fi) {
      Node* f = frontier[fi];
      for (auto& [dep_id, idx] : f->deps) {
        Node* dep = g.get(dep_id);
        if (dep && !fseen.count(dep->id)) {
          fseen.insert(dep->id);
          frontier.push_back(dep);
        }
      }
      for (uint64_t d_id : f->dependents) {
        Node* d = g.get(d_id);
        if (d && !fseen.count(d_id) && d->materialized &&
            storages_intersect(*d, *f)) {
          fseen.insert(d_id);
          frontier.push_back(d);
        }
      }
    }
    // (a) aliasing dependents of any frontier node, up to the last
    // in-place node.
    for (Node* f : frontier) {
      for (uint64_t d_id : f->dependents) {
        Node* d = g.get(d_id);
        if (!d || included.count(d->id) || d->materialized) continue;
        if (d->op_nr <= last->op_nr && storages_intersect(*d, *f)) {
          visit(d);
          changed = true;
        }
      }
    }
    // (b) readers clobbered by a later included mutation of a storage an
    // earlier frontier node aliases.  Indexed by storage key so the scan
    // touches only genuinely aliasing (n, v) pairs.
    std::unordered_map<uint64_t, std::vector<Node*>> carriers_by_storage;
    for (Node* v : frontier)
      for (uint64_t sk : v->storages) carriers_by_storage[sk].push_back(v);
    for (Node* n : snapshot) {
      std::unordered_set<uint64_t> seen_v;
      for (uint64_t sk : n->storages) {
        auto it = carriers_by_storage.find(sk);
        if (it == carriers_by_storage.end()) continue;
        for (Node* v : it->second) {
          if (v == n || seen_v.count(v->id) || v->op_nr >= n->op_nr) continue;
          seen_v.insert(v->id);
          for (uint64_t r_id : v->dependents) {
            Node* r = g.get(r_id);
            if (!r || included.count(r_id) || r->materialized) continue;
            if (r->op_nr < n->op_nr && !storages_intersect(*r, *v)) {
              visit(r);
              changed = true;
            }
          }
        }
      }
    }
  }

  std::vector<Node*> sorted;
  sorted.reserve(included.size());
  for (auto& [id, n] : included) sorted.push_back(n);
  std::sort(sorted.begin(), sorted.end(),
            [](Node* a, Node* b) { return a->op_nr < b->op_nr; });
  std::vector<uint64_t> ids;
  ids.reserve(sorted.size());
  for (Node* n : sorted) ids.push_back(n->id);
  return ids;
}

}  // namespace

TDX_API void* tdx_graph_create() { return new Graph(); }

TDX_API void tdx_graph_destroy(void* gp) { delete static_cast<Graph*>(gp); }

TDX_API uint64_t tdx_node_create(void* gp) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  uint64_t id = g.next_id++;
  Node& n = g.nodes[id];
  n.id = id;
  n.op_nr = g.next_op_nr++;
  return id;
}

// Destroy a node, erasing its back-edges from its dependencies (the
// reference's OpNode destructor semantics, deferred_init.cc:409-411).
TDX_API void tdx_node_destroy(void* gp, uint64_t id) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  if (!n) return;
  for (auto& [dep_id, idx] : n->deps) {
    Node* dep = g.get(dep_id);
    if (!dep) continue;
    auto& v = dep->dependents;
    v.erase(std::remove(v.begin(), v.end(), id), v.end());
  }
  g.nodes.erase(id);
}

TDX_API void tdx_node_add_storage(void* gp, uint64_t id, uint64_t key) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  if (n) n->storages.push_back(key);
}

TDX_API void tdx_node_add_dep(void* gp, uint64_t id, uint64_t dep_id,
                              int32_t out_idx) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  Node* dep = g.get(dep_id);
  if (!n || !dep) return;
  n->deps.emplace_back(dep_id, out_idx);
  dep->dependents.push_back(id);
}

TDX_API void tdx_node_set_materialized(void* gp, uint64_t id, int32_t value) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  if (n) n->materialized = value != 0;
}

TDX_API uint64_t tdx_last_in_place(void* gp, uint64_t id) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  if (!n) return 0;
  return last_in_place(g, *n)->id;
}

// Writes up to `cap` node ids (chronological order) into `out`; returns
// the total count (call again with a bigger buffer if count > cap).
TDX_API uint64_t tdx_build_call_stack(void* gp, uint64_t id, uint64_t* out,
                                      uint64_t cap) {
  Graph& g = *static_cast<Graph*>(gp);
  std::lock_guard<std::mutex> lock(g.mu);
  Node* n = g.get(id);
  if (!n) return 0;
  std::vector<uint64_t> ids = build_call_stack(g, *n);
  uint64_t count = ids.size();
  for (uint64_t i = 0; i < count && i < cap; ++i) out[i] = ids[i];
  return count;
}
