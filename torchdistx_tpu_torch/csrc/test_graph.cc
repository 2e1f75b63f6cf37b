// Native unit tests for the graph engine (the port's copy of the JAX
// package's csrc/test_graph.cc).  Build and run with the flags the port
// builds the library with:
//
//   c++ -std=c++17 -O2 -fPIC -fvisibility=hidden -Wall -Wextra -pthread \
//       -o test_graph tdx_graph.cc test_graph.cc && ./test_graph
//
// (tests/test_torch_native.py does this; add -fsanitize=thread for the
// concurrent record-while-materialize stress below under TSan.)

#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

extern "C" {
void* tdx_graph_create();
void tdx_graph_destroy(void*);
uint64_t tdx_node_create(void*);
void tdx_node_destroy(void*, uint64_t);
void tdx_node_add_storage(void*, uint64_t, uint64_t);
void tdx_node_add_dep(void*, uint64_t, uint64_t, int32_t);
void tdx_node_set_materialized(void*, uint64_t, int32_t);
uint64_t tdx_last_in_place(void*, uint64_t);
uint64_t tdx_build_call_stack(void*, uint64_t, uint64_t*, uint64_t);
}

static std::vector<uint64_t> stack_of(void* g, uint64_t id) {
  uint64_t buf[64];
  uint64_t n = tdx_build_call_stack(g, id, buf, 64);
  assert(n <= 64);
  return std::vector<uint64_t>(buf, buf + n);
}

// Concurrency stress: recorder threads append alias chains (create /
// add_storage / add_dep / set_materialized / destroy) while materializer
// threads walk last-in-place and call stacks over whatever ids have been
// published — the exact interleaving the reference guards with its graph
// mutex (deferred_init.cc:1106-1129: recording on one thread while
// materializing on another).  Every C API call locks the graph's mutex,
// so a -fsanitize=thread build of this file must come back green;
// that TSan lane is the contract this test exists to keep.
static void stress_record_while_materializing() {
  void* g = tdx_graph_create();
  constexpr int kRecorders = 4;
  constexpr int kMaterializers = 3;
  constexpr int kOps = 1200;
  std::atomic<uint64_t> max_id{0};
  std::atomic<bool> recording{true};

  std::vector<std::thread> threads;
  for (int t = 0; t < kRecorders; ++t) {
    threads.emplace_back([&, t] {
      uint64_t prev = 0;
      for (int i = 0; i < kOps; ++i) {
        uint64_t id = tdx_node_create(g);
        // Storage keys cycle over a small shared set so materializer
        // walks cross alias boundaries authored by other threads.
        tdx_node_add_storage(g, id,
                             0x100 + static_cast<uint64_t>((t + i) % 4));
        if (prev) tdx_node_add_dep(g, id, prev, 0);
        if (i % 7 == 3) tdx_node_set_materialized(g, id, 1);
        if (i % 11 == 5 && prev) {
          tdx_node_destroy(g, prev);
          prev = 0;
        } else {
          prev = id;
        }
        uint64_t cur = max_id.load(std::memory_order_relaxed);
        while (id > cur && !max_id.compare_exchange_weak(
                               cur, id, std::memory_order_relaxed)) {
        }
      }
    });
  }
  for (int t = 0; t < kMaterializers; ++t) {
    threads.emplace_back([&, t] {
      uint64_t buf[256];
      uint64_t probe = static_cast<uint64_t>(t) + 1;
      while (recording.load(std::memory_order_relaxed)) {
        uint64_t hi = max_id.load(std::memory_order_relaxed);
        if (hi == 0) continue;
        probe = probe * 2654435761ull + 1;  // cheap deterministic hash walk
        uint64_t id = 1 + probe % hi;
        tdx_last_in_place(g, id);  // 0 (destroyed) or a live node id
        uint64_t n = tdx_build_call_stack(g, id, buf, 256);
        if (n > 0 && n <= 256) {
          // Chronological order == ascending ids (op_nr tracks next_id),
          // even for stacks snapshotted mid-recording.
          for (uint64_t k = 1; k < n; ++k) assert(buf[k - 1] < buf[k]);
        }
      }
    });
  }
  for (int t = 0; t < kRecorders; ++t) threads[t].join();
  recording.store(false);
  for (size_t t = kRecorders; t < threads.size(); ++t) threads[t].join();

  // The graph must still answer exact queries after the storm.
  uint64_t b1 = tdx_node_create(g);
  uint64_t b2 = tdx_node_create(g);
  tdx_node_add_storage(g, b1, 0xBEEF);
  tdx_node_add_storage(g, b2, 0xBEEF);
  tdx_node_add_dep(g, b2, b1, 0);
  assert(tdx_last_in_place(g, b1) == b2);
  auto s = stack_of(g, b2);
  assert((s == std::vector<uint64_t>{b1, b2}));
  tdx_graph_destroy(g);
}

int main() {
  // Scenario from tests/test_deferred_init.py::test_in_place_through_view:
  //   n1 = empty(w)        storage S
  //   n2 = fill_(w)        storage S  (dep n1)
  //   n3 = select(w)->v    storage S  (dep n2)
  //   n4 = add_(v)         storage S  (dep n3)
  //   n5 = mul_(w)         storage S  (dep n2!)  <- w's ctx was n2
  void* g = tdx_graph_create();
  uint64_t n1 = tdx_node_create(g);
  uint64_t n2 = tdx_node_create(g);
  uint64_t n3 = tdx_node_create(g);
  uint64_t n4 = tdx_node_create(g);
  uint64_t n5 = tdx_node_create(g);
  const uint64_t S = 0xABCD;
  for (uint64_t n : {n1, n2, n3, n4, n5}) tdx_node_add_storage(g, n, S);
  tdx_node_add_dep(g, n2, n1, 0);
  tdx_node_add_dep(g, n3, n2, 0);
  tdx_node_add_dep(g, n4, n3, 0);
  tdx_node_add_dep(g, n5, n2, 0);

  // materialize(w) at n5: last in place is n5 itself; stack must include
  // the view chain n3,n4 (they alias S) in chronological order.
  assert(tdx_last_in_place(g, n5) == n5);
  auto s = stack_of(g, n5);
  assert((s == std::vector<uint64_t>{n1, n2, n3, n4, n5}));

  // materialize(v) at n4: the later mutation n5 of the shared storage is
  // INCLUDED — eager semantics (v is a view of w; mul_(w) changes v). The
  // bidirectional last-in-place walk reaches n5 via the dependency edge
  // n4 -> n3 -> n2 -> dependent n5 (the reference's dependents-only walk
  // missed it and replayed the stale value).
  assert(tdx_last_in_place(g, n4) == n5);
  auto sv = stack_of(g, n4);
  assert((sv == std::vector<uint64_t>{n1, n2, n3, n4, n5}));

  // last-in-place from the producer n2 must find n5.
  assert(tdx_last_in_place(g, n2) == n5);

  // Materialized nodes prune the dependency closure: with the whole
  // prefix replayed (as a real materialize would have done — replayed
  // real tensors carry alias state), only the requested node remains.
  for (uint64_t n : {n1, n2, n3, n4}) tdx_node_set_materialized(g, n, 1);
  auto sm = stack_of(g, n5);
  assert((sm == std::vector<uint64_t>{n5}));

  // node destruction erases back-edges: destroy n5, n2's dependents must
  // no longer reach it.
  tdx_node_destroy(g, n5);
  assert(tdx_last_in_place(g, n4) == n4);

  // clobbered reader: r reads storage A's output (no alias), then an
  // in-place op clobbers A before the requested node.
  //   a1 = empty (A); r = mm(a) -> storage R; a2 = mul_(a) (A, dep a1)
  uint64_t a1 = tdx_node_create(g);
  uint64_t r = tdx_node_create(g);
  uint64_t a2 = tdx_node_create(g);
  tdx_node_add_storage(g, a1, 0x1);
  tdx_node_add_storage(g, r, 0x2);
  tdx_node_add_storage(g, a2, 0x1);
  tdx_node_add_dep(g, r, a1, 0);
  tdx_node_add_dep(g, a2, a1, 0);
  auto sc = stack_of(g, a2);
  assert((sc == std::vector<uint64_t>{a1, r, a2}));  // r pulled in before a2

  // buffer-too-small path returns the true count without overflow.
  uint64_t tiny[1];
  uint64_t need = tdx_build_call_stack(g, a2, tiny, 1);
  assert(need == 3);

  tdx_graph_destroy(g);

  stress_record_while_materializing();

  std::puts("native graph tests OK");
  return 0;
}
