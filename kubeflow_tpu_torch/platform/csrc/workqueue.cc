// kfq_*: native delaying, rate-limited, deduplicating workqueue.
//
// Mirrors kubeflow_tpu_torch/platform/runtime/controller.py::_WorkQueue (which in
// turn mirrors the Go client-go util/workqueue the reference controllers use).
// Keys are opaque int64s — the Python side maps Request objects to ids so the
// hot enqueue/dequeue path (every watch event for every controller) runs
// without the GIL-held Python heap operations.
//
// Semantics (must stay in lock-step with the Python implementation):
//   * add(key, delay): an entry at least as early already pending → no-op;
//     otherwise (re)schedule, superseding any later pending entry.  A key
//     currently processing (returned by get, not yet done) parks in the
//     dirty set instead and re-enqueues on done — per-key mutual exclusion
//     so multiple workers never reconcile one key concurrently (client-go
//     workqueue semantics).
//   * add_rate_limited(key): exponential backoff 2^failures * base, capped.
//   * forget(key): reset the failure count (called after a clean reconcile).
//   * get(timeout): block until an entry is due or timeout; pops the live
//     entry, dropping stale superseded heap nodes; marks it processing.
//   * done(key): release the key; a parked dirty re-add fires (earliest
//     requested time wins, so backoffs aren't flattened to immediate).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace kfq {

using Clock = std::chrono::steady_clock;
using TimePoint = Clock::time_point;

struct Entry {
  TimePoint when;
  uint64_t seq;
  int64_t key;
  bool operator>(const Entry& o) const {
    if (when != o.when) return when > o.when;
    return seq > o.seq;
  }
};

class Queue {
 public:
  Queue(double base_delay_s, double max_delay_s)
      : base_(base_delay_s), max_(max_delay_s) {}

  void add(int64_t key, double delay_s) {
    std::lock_guard<std::mutex> lk(mu_);
    if (shutdown_) return;
    TimePoint when =
        Clock::now() + std::chrono::duration_cast<Clock::duration>(
                           std::chrono::duration<double>(delay_s < 0 ? 0 : delay_s));
    if (processing_.count(key)) {
      auto d = dirty_.find(key);
      if (d == dirty_.end() || when < d->second) dirty_[key] = when;
      return;
    }
    auto it = pending_.find(key);
    if (it != pending_.end() && it->second.second <= when) return;
    ++seq_;
    pending_[key] = {seq_, when};
    heap_.push(Entry{when, seq_, key});
    cv_.notify_one();
  }

  void done(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    processing_.erase(key);
    auto d = dirty_.find(key);
    if (d == dirty_.end()) return;
    TimePoint when = d->second;
    dirty_.erase(d);
    if (shutdown_) return;
    ++seq_;
    pending_[key] = {seq_, when};
    heap_.push(Entry{when, seq_, key});
    cv_.notify_one();
  }

  bool is_processing(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    return processing_.count(key) != 0;
  }

  void add_rate_limited(int64_t key) {
    double delay;
    {
      std::lock_guard<std::mutex> lk(mu_);
      int n = failures_[key]++;
      delay = base_ * static_cast<double>(1ULL << (n > 62 ? 62 : n));
      if (delay > max_) delay = max_;
    }
    add(key, delay);
  }

  void forget(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    failures_.erase(key);
  }

  int failures(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = failures_.find(key);
    return it == failures_.end() ? 0 : it->second;
  }

  bool is_pending(int64_t key) {
    std::lock_guard<std::mutex> lk(mu_);
    return pending_.count(key) != 0 || dirty_.count(key) != 0;
  }

  // Returns the popped key, or -1 on timeout / shutdown.
  int64_t get(double timeout_s) {
    std::unique_lock<std::mutex> lk(mu_);
    TimePoint deadline =
        Clock::now() + std::chrono::duration_cast<Clock::duration>(
                           std::chrono::duration<double>(timeout_s));
    while (true) {
      if (shutdown_) return -1;
      TimePoint now = Clock::now();
      // Drop stale heap nodes eagerly.
      while (!heap_.empty()) {
        const Entry& top = heap_.top();
        auto it = pending_.find(top.key);
        if (it == pending_.end() || it->second.first != top.seq) {
          heap_.pop();
          continue;
        }
        break;
      }
      if (!heap_.empty() && heap_.top().when <= now) {
        Entry e = heap_.top();
        heap_.pop();
        pending_.erase(e.key);
        processing_.insert(e.key);
        return e.key;
      }
      if (now >= deadline) return -1;
      TimePoint until = deadline;
      if (!heap_.empty() && heap_.top().when < until) until = heap_.top().when;
      cv_.wait_until(lk, until);
    }
  }

  size_t pending_count() {
    std::lock_guard<std::mutex> lk(mu_);
    return pending_.size() + dirty_.size();
  }

  void shut_down() {
    std::lock_guard<std::mutex> lk(mu_);
    shutdown_ = true;
    cv_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap_;
  // key -> (seq of live entry, scheduled time)
  std::unordered_map<int64_t, std::pair<uint64_t, TimePoint>> pending_;
  std::unordered_set<int64_t> processing_;
  std::unordered_map<int64_t, TimePoint> dirty_;
  std::unordered_map<int64_t, int> failures_;
  uint64_t seq_ = 0;
  double base_;
  double max_;
  bool shutdown_ = false;
};

}  // namespace kfq

extern "C" {

void* kfq_new(double base_delay_s, double max_delay_s) {
  return new kfq::Queue(base_delay_s, max_delay_s);
}

void kfq_delete(void* q) { delete static_cast<kfq::Queue*>(q); }

void kfq_add(void* q, int64_t key, double delay_s) {
  static_cast<kfq::Queue*>(q)->add(key, delay_s);
}

void kfq_add_rate_limited(void* q, int64_t key) {
  static_cast<kfq::Queue*>(q)->add_rate_limited(key);
}

void kfq_forget(void* q, int64_t key) {
  static_cast<kfq::Queue*>(q)->forget(key);
}

int kfq_failures(void* q, int64_t key) {
  return static_cast<kfq::Queue*>(q)->failures(key);
}

int kfq_is_pending(void* q, int64_t key) {
  return static_cast<kfq::Queue*>(q)->is_pending(key) ? 1 : 0;
}

int64_t kfq_get(void* q, double timeout_s) {
  return static_cast<kfq::Queue*>(q)->get(timeout_s);
}

void kfq_done(void* q, int64_t key) {
  static_cast<kfq::Queue*>(q)->done(key);
}

int kfq_is_processing(void* q, int64_t key) {
  return static_cast<kfq::Queue*>(q)->is_processing(key) ? 1 : 0;
}

int64_t kfq_pending(void* q) {
  return static_cast<int64_t>(static_cast<kfq::Queue*>(q)->pending_count());
}

void kfq_shutdown(void* q) { static_cast<kfq::Queue*>(q)->shut_down(); }

}  // extern "C"
