// tagged_broker — native message core for the host-async PS transport.
//
// Reference parity (SURVEY.md §2 comp. 1): the reference's only native
// component was a C binding exposing MPI's tagged send/recv surface to the
// training runtime. The TPU build's collective path needs no such shim (XLA
// *is* the native collective backend — SURVEY.md §2 native-component
// ledger), but the host-async parameter-server mode still moves tagged
// messages between actor threads; this library is that data plane in C++:
// per-rank mailboxes, MPI-style (src, tag) wildcard matching, and
// condition-variable blocking receives that run entirely outside the Python
// GIL (ctypes releases it for the duration of the call, so a blocked
// pserver recv costs the clients nothing).
//
// C ABI (for ctypes):
//   mpit_broker_create(size)                  -> handle
//   mpit_broker_send(h, src, dst, tag, p, n)  -> 0 / -1
//   mpit_broker_recv(h, rank, src, tag, t_s)  -> lease id >= 0 | -1 timeout
//                                                | -2 bad args | -3 closed
//   mpit_broker_probe(h, rank, src, tag)      -> 1 / 0 / -1
//   mpit_broker_probe_wait(h, rank, src, tag, t_s)
//                                             -> 1 found | 0 timeout
//                                                | -2 bad args | -3 closed
//   mpit_lease_info(h, lease, &src, &tag, &len)
//   mpit_lease_copy_free(h, lease, out)       -> copies payload, ends lease
//   mpit_lease_free(h, lease)                 -> drops payload, ends lease
//   mpit_broker_shutdown(h)                   -> refuse new work, wake waiters
//   mpit_broker_destroy(h)                    -> shutdown + drain + free
//
// A "lease" is a received message parked C-side until the caller has
// allocated a buffer of the right size; info -> copy_free is the two-phase
// read. Wildcards use -1 (ANY_SOURCE / ANY_TAG), matching
// mpit_tpu.transport.base.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kAny = -1;

struct Msg {
  int src;
  int tag;
  std::vector<char> data;
};

bool Matches(const Msg& m, int src, int tag) {
  return (src == kAny || src == m.src) && (tag == kAny || tag == m.tag);
}

struct Mailbox {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Msg> q;
};

struct Broker {
  explicit Broker(int n) : size(n), boxes(n) {}
  const int size;
  std::vector<Mailbox> boxes;  // constructed in place, never reallocated

  std::mutex lease_mu;
  int64_t next_lease = 0;
  std::map<int64_t, Msg> leases;

  // shutdown protocol: destroy() flips `shutting_down`, wakes every waiter,
  // and spins until `ops` (in-flight API calls) drains before deleting —
  // otherwise a thread parked in cv.wait would be left waiting on a freed
  // condvar (use-after-free). `ops` must be each call's LAST broker access.
  std::atomic<bool> shutting_down{false};
  std::atomic<int> ops{0};
};

// RAII in-flight-call marker; the destructor's decrement is the final
// touch of broker state on every API path.
struct OpGuard {
  explicit OpGuard(Broker* broker) : b(broker) { b->ops.fetch_add(1); }
  ~OpGuard() { b->ops.fetch_sub(1); }
  Broker* b;
};

// Pop the first message in arrival order matching (src, tag); caller holds
// box.mu. Returns true and moves the message out on a hit.
bool TakeMatch(Mailbox& box, int src, int tag, Msg* out) {
  for (auto it = box.q.begin(); it != box.q.end(); ++it) {
    if (Matches(*it, src, tag)) {
      *out = std::move(*it);
      box.q.erase(it);
      return true;
    }
  }
  return false;
}

}  // namespace

extern "C" {

void* mpit_broker_create(int size) {
  if (size < 1) return nullptr;
  return new Broker(size);
}

// Phase 1 of teardown: refuse new work and wake every parked receiver
// (they return -3). Does NOT free — the caller drains its in-flight calls
// first, then calls destroy. Splitting the phases lets the Python wrapper
// close the entry/increment race entirely on its side: it gates every API
// call behind its own counter, flips "closing" (no new entries), calls
// shutdown, waits for its counter to hit zero, and only then destroys.
void mpit_broker_shutdown(void* h) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr) return;
  b->shutting_down.store(true);
  for (Mailbox& box : b->boxes) {
    // notify under the lock: a waiter between its predicate check and its
    // sleep would otherwise miss the wakeup forever
    std::lock_guard<std::mutex> g(box.mu);
    box.cv.notify_all();
  }
}

// Phase 2: free. The `ops` drain is defense in depth — the wrapper already
// guarantees quiescence (see shutdown above); `ops` alone cannot, since a
// caller holding the raw handle may sit between its null-check and its
// OpGuard increment when the spin loop reads zero.
void mpit_broker_destroy(void* h) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr) return;
  mpit_broker_shutdown(h);
  while (b->ops.load() != 0) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  delete b;
}

int mpit_broker_send(void* h, int src, int dst, int tag, const char* data,
                     uint64_t len) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr || src < 0 || src >= b->size || dst < 0 || dst >= b->size)
    return -1;
  OpGuard op(b);
  if (b->shutting_down.load()) return -3;
  Msg m{src, tag, std::vector<char>(data, data + len)};
  Mailbox& box = b->boxes[dst];
  {
    std::lock_guard<std::mutex> g(box.mu);
    box.q.push_back(std::move(m));
  }
  // notify_all, not _one: concurrent receivers may wait on different
  // (src, tag) filters and the woken one is not necessarily the match
  box.cv.notify_all();
  return 0;
}

int64_t mpit_broker_recv(void* h, int rank, int src, int tag,
                         double timeout_s) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr || rank < 0 || rank >= b->size) return -2;
  OpGuard op(b);
  Mailbox& box = b->boxes[rank];
  Msg m;
  bool got = false;
  {
    std::unique_lock<std::mutex> lk(box.mu);
    auto ready = [&] {
      return b->shutting_down.load() || (got = TakeMatch(box, src, tag, &m));
    };
    if (timeout_s < 0) {
      box.cv.wait(lk, ready);
    } else {
      auto dur = std::chrono::duration<double>(timeout_s);
      if (!box.cv.wait_for(lk, dur, ready)) return -1;
    }
  }
  if (!got) return -3;  // woken by shutdown
  std::lock_guard<std::mutex> g(b->lease_mu);
  int64_t id = b->next_lease++;
  b->leases.emplace(id, std::move(m));
  return id;
}

int mpit_broker_probe(void* h, int rank, int src, int tag) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr || rank < 0 || rank >= b->size) return -1;
  OpGuard op(b);
  if (b->shutting_down.load()) return -1;
  Mailbox& box = b->boxes[rank];
  std::lock_guard<std::mutex> g(box.mu);
  for (const Msg& m : box.q) {
    if (Matches(m, src, tag)) return 1;
  }
  return 0;
}

// Blocking probe (MPI_Probe parity): park until a matching message is
// available WITHOUT consuming it. timeout_s < 0 blocks indefinitely.
// Returns 1 found, 0 timeout, -2 bad args, -3 woken by shutdown.
int mpit_broker_probe_wait(void* h, int rank, int src, int tag,
                           double timeout_s) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr || rank < 0 || rank >= b->size) return -2;
  OpGuard op(b);
  Mailbox& box = b->boxes[rank];
  bool found = false;
  {
    std::unique_lock<std::mutex> lk(box.mu);
    auto ready = [&] {
      if (b->shutting_down.load()) return true;
      for (const Msg& m : box.q) {
        if (Matches(m, src, tag)) {
          found = true;
          return true;
        }
      }
      return false;
    };
    if (timeout_s < 0) {
      box.cv.wait(lk, ready);
    } else {
      auto dur = std::chrono::duration<double>(timeout_s);
      if (!box.cv.wait_for(lk, dur, ready)) return 0;
    }
  }
  return found ? 1 : -3;
}

// Drop a parked lease without copying its payload — the error-path cleanup
// for a receiver that failed between recv and copy_free (otherwise the
// message would sit in the lease map for the broker's lifetime).
int mpit_lease_free(void* h, int64_t lease) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr) return -1;
  OpGuard op(b);
  std::lock_guard<std::mutex> g(b->lease_mu);
  return b->leases.erase(lease) != 0 ? 0 : -1;
}

int mpit_lease_info(void* h, int64_t lease, int* src, int* tag,
                    uint64_t* len) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr) return -1;
  OpGuard op(b);
  std::lock_guard<std::mutex> g(b->lease_mu);
  auto it = b->leases.find(lease);
  if (it == b->leases.end()) return -1;
  *src = it->second.src;
  *tag = it->second.tag;
  *len = it->second.data.size();
  return 0;
}

int mpit_lease_copy_free(void* h, int64_t lease, char* out) {
  auto* b = static_cast<Broker*>(h);
  if (b == nullptr) return -1;
  OpGuard op(b);
  Msg m;
  {
    std::lock_guard<std::mutex> g(b->lease_mu);
    auto it = b->leases.find(lease);
    if (it == b->leases.end()) return -1;
    m = std::move(it->second);
    b->leases.erase(it);
  }
  if (!m.data.empty()) std::memcpy(out, m.data.data(), m.data.size());
  return 0;
}

}  // extern "C"
