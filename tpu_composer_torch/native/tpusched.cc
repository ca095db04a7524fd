// tpusched.cc — native placement kernel over the packed chip-index
// snapshot (tpu_composer_torch/scheduler/snapshot.py); the port's own copy
// of the JAX package's native/tpusched.cc, built at first use by
// tpu_composer_torch/scheduler/native.py with the host C++ compiler.
//
// The ICI-contiguity window below prefers the smallest span of consecutive
// fabric indices (host names' trailing numbers). H100 hosts meet over
// InfiniBand with no torus, so for them the window changes nothing that
// matters; it is kept so that TPU rows decide exactly as the JAX package.
//
// Three scans, C ABI, loaded via ctypes (scheduler/native.py):
//
//   tpus_scan     tightest-fit + ICI-contiguity-window host selection AND
//                 the per-node candidate-verdict scan for the decision
//                 ledger, in one pass — the ledger reads the same scan the
//                 placement ran instead of re-walking the cluster.
//   tpus_victims  the preemption minimal-victim-set search (exhaustive
//                 subset enumeration under the same bounds as
//                 scheduler/preemption.py, greedy+prune beyond them).
//
// Bit-identical contract: the Python engine sorts nodes by
// (value, node-name); the snapshot packs arrays in name-sorted order, so
// every tiebreak here is (value, index). Candidate victims arrive
// pre-sorted with a name-rank column for the tuple-of-names tiebreak.
// Any semantic change here MUST be mirrored in snapshot.py's py_scan /
// preemption.py and is enforced by tests/test_torch_native_sched.py's
// differential fuzz.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

// Verdict codes — must match snapshot.py V_*.
enum Verdict {
  V_OK = 0,
  V_EXCLUDED = 1,
  V_QUARANTINED = 2,
  V_NOT_READY = 3,
  V_CORDONED = 4,
  V_NO_PORTS = 5,
  V_NODE_RESOURCES = 6,
};

// State-mask bits — must match snapshot.py F_*.
enum Flag {
  F_EXCLUDED = 1,
  F_QUARANTINED = 2,
  F_NOT_READY = 4,
  F_CORDONED = 8,
};

}  // namespace

extern "C" int tpus_version(void) { return 1; }

// One pass over n nodes: per-node clamped free chips and verdict code,
// the candidate-verdicts ordering (fitting nodes in tightest-fit order —
// least free-after-placement first — then rejected nodes in index order),
// and, when count >= 1 and enough nodes fit, the selected host indices
// (greedy tightest-fit refined by the smallest-span window of consecutive
// fabric indices that ties the packing optimum).
//
// Returns the number of fitting nodes (>= 0), or -1 on bad arguments.
// out_sel is written only when count >= 1 and num_ok >= count.
extern "C" int tpus_scan(
    int32_t n,
    const int32_t* slots, const int32_t* used, const int32_t* hidx,
    const uint8_t* flags,
    const int64_t* cpu, const int64_t* mem,
    const int64_t* eph, const int64_t* pods,
    int32_t has_other,
    int64_t need_cpu, int64_t need_mem, int64_t need_eph, int64_t need_pods,
    int32_t chips, int32_t count,
    int32_t* out_free, int32_t* out_verdict, int32_t* out_order,
    int32_t* out_sel) {
  if (n < 0 || !slots || !used || !hidx || !flags || !out_free ||
      !out_verdict || !out_order)
    return -1;
  std::vector<int32_t> raw(n);
  std::vector<int32_t> ok;
  ok.reserve(n);
  std::vector<int32_t> rejected;
  for (int32_t i = 0; i < n; i++) {
    int32_t f = slots[i] - used[i];
    raw[i] = f;
    out_free[i] = f > 0 ? f : 0;
    uint8_t fl = flags[i];
    int32_t v;
    if (fl & F_EXCLUDED) v = V_EXCLUDED;
    else if (fl & F_QUARANTINED) v = V_QUARANTINED;
    else if (fl & F_NOT_READY) v = V_NOT_READY;
    else if (fl & F_CORDONED) v = V_CORDONED;
    else if (f < chips) v = V_NO_PORTS;
    else if (has_other &&
             (cpu[i] < need_cpu || mem[i] < need_mem ||
              eph[i] < need_eph || pods[i] < need_pods))
      v = V_NODE_RESOURCES;
    else { v = V_OK; ok.push_back(i); }
    out_verdict[i] = v;
    if (v != V_OK) rejected.push_back(i);
  }
  std::sort(ok.begin(), ok.end(), [&](int32_t a, int32_t b) {
    if (raw[a] != raw[b]) return raw[a] < raw[b];
    return a < b;
  });
  int32_t num_ok = (int32_t)ok.size();
  int32_t* p = out_order;
  for (int32_t i : ok) *p++ = i;
  for (int32_t i : rejected) *p++ = i;

  if (count < 1 || num_ok < count || !out_sel) return num_ok;
  if (count == 1) {
    out_sel[0] = ok[0];
    return num_ok;
  }
  int64_t best_sum = 0;
  for (int32_t k = 0; k < count; k++) best_sum += raw[ok[k]];

  std::vector<int32_t> indexed;
  indexed.reserve(num_ok);
  for (int32_t i : ok)
    if (hidx[i] >= 0) indexed.push_back(i);
  std::sort(indexed.begin(), indexed.end(), [&](int32_t a, int32_t b) {
    if (hidx[a] != hidx[b]) return hidx[a] < hidx[b];
    return a < b;
  });
  bool have_best = false;
  int64_t best_span = 0, best_start = 0;
  int32_t best_at = 0;
  int32_t m = (int32_t)indexed.size();
  for (int32_t s = 0; s + count <= m; s++) {
    bool dup = false;
    for (int32_t j = 0; j < count - 1; j++)
      if (hidx[indexed[s + j]] == hidx[indexed[s + j + 1]]) { dup = true; break; }
    if (dup) continue;  // duplicate trailing integers are not adjacency
    int64_t sum = 0;
    for (int32_t j = 0; j < count; j++) sum += raw[indexed[s + j]];
    if (sum != best_sum) continue;  // refinement must tie the packing optimum
    int64_t span =
        (int64_t)hidx[indexed[s + count - 1]] - hidx[indexed[s]] - (count - 1);
    int64_t start = hidx[indexed[s]];
    if (!have_best || span < best_span ||
        (span == best_span && start < best_start)) {
      have_best = true;
      best_span = span;
      best_start = start;
      best_at = s;
    }
  }
  if (have_best) {
    for (int32_t j = 0; j < count; j++) out_sel[j] = indexed[best_at + j];
  } else {
    for (int32_t j = 0; j < count; j++) out_sel[j] = ok[j];
  }
  return num_ok;
}

namespace {

// Feasibility state for the victim search: a mutable sim copy of the used
// column with undo, and an incrementally-maintained count of fitting
// usable nodes (only nodes touched by a combo's freed entries can change
// fitting state, so each probe is O(freed entries), not O(n)).
struct VictimSim {
  int32_t n;
  const int32_t* slots;
  int32_t chips;
  int32_t num_hosts;
  int32_t target_mode;  // 0 none, 1 usable target, 2 target never feasible
  int32_t target_idx;
  std::vector<uint8_t> res_ok;  // usable && other-resources fit
  std::vector<int32_t> sim;
  int32_t fit_count = 0;
  std::vector<std::pair<int32_t, int32_t>> undo;  // (idx, old sim value)

  bool fits(int32_t i) const {
    return res_ok[i] && slots[i] - sim[i] >= chips;
  }

  void apply_cand(int32_t c, const int32_t* off, const int32_t* fidx,
                  const int32_t* famt) {
    for (int32_t k = off[c]; k < off[c + 1]; k++) {
      int32_t i = fidx[k];
      int32_t before = sim[i];
      int32_t after = before - famt[k];
      if (after < 0) after = 0;  // max(0, sim - chips), order-independent
      if (after == before) continue;
      bool f0 = fits(i);
      sim[i] = after;
      bool f1 = fits(i);
      fit_count += (int32_t)f1 - (int32_t)f0;
      undo.emplace_back(i, before);
    }
  }

  void revert() {
    for (auto it = undo.rbegin(); it != undo.rend(); ++it) {
      int32_t i = it->first;
      bool f0 = fits(i);
      sim[i] = it->second;
      bool f1 = fits(i);
      fit_count += (int32_t)f1 - (int32_t)f0;
    }
    undo.clear();
  }

  bool feasible_now() const {
    if (target_mode != 0) {
      return target_mode == 1 && num_hosts == 1 && fits(target_idx);
    }
    return fit_count >= num_hosts;
  }

  // feasible(combo of candidate indices): apply, evaluate, revert.
  bool feasible(const int32_t* combo, int32_t k, const int32_t* off,
                const int32_t* fidx, const int32_t* famt) {
    for (int32_t j = 0; j < k; j++) apply_cand(combo[j], off, fidx, famt);
    bool ok = feasible_now();
    revert();
    return ok;
  }
};

}  // namespace

// Minimal victim-set search over pre-sorted candidates (the caller sorts
// by (priority, total_chips, creation, name) and supplies the name-rank
// column for the tuple-of-names tiebreak). Freed capacity arrives as CSR
// arrays of (node index, chips) per candidate, already filtered to usable
// nodes. Returns the number of victims written to out_sel (candidate
// indices); out_info = {mode, set_size, priority_sum, chips_sum} with
// mode 0 = infeasible (even evicting everyone), 1 = exhaustive,
// 2 = greedy+prune. "disallowed" / "no-candidates" never reach here.
extern "C" int tpus_victims(
    int32_t n,
    const int32_t* slots, const int32_t* used, const uint8_t* usable,
    const int64_t* cpu, const int64_t* mem,
    const int64_t* eph, const int64_t* pods,
    int32_t has_other,
    int64_t need_cpu, int64_t need_mem, int64_t need_eph, int64_t need_pods,
    int32_t chips, int32_t num_hosts,
    int32_t target_mode, int32_t target_idx,
    int32_t ncand,
    const int64_t* cand_prio, const int64_t* cand_chips,
    const int32_t* cand_rank,
    const int32_t* freed_off, const int32_t* freed_idx,
    const int32_t* freed_amt,
    int32_t max_exh_cands, int32_t max_exh_size,
    int32_t* out_sel, int64_t* out_info) {
  if (n < 0 || ncand <= 0 || !slots || !used || !usable || !out_sel ||
      !out_info)
    return -1;
  if (target_mode == 1 && (target_idx < 0 || target_idx >= n)) return -1;

  VictimSim vs;
  vs.n = n;
  vs.slots = slots;
  vs.chips = chips;
  vs.num_hosts = num_hosts;
  vs.target_mode = target_mode;
  vs.target_idx = target_mode == 1 ? target_idx : 0;
  vs.res_ok.resize(n);
  vs.sim.assign(used, used + n);
  for (int32_t i = 0; i < n; i++) {
    bool ok = usable[i] != 0;
    if (ok && has_other &&
        (cpu[i] < need_cpu || mem[i] < need_mem || eph[i] < need_eph ||
         pods[i] < need_pods))
      ok = false;
    vs.res_ok[i] = ok ? 1 : 0;
    if (ok && vs.fits(i)) vs.fit_count++;
  }

  out_info[0] = 0;
  out_info[1] = 0;
  out_info[2] = 0;
  out_info[3] = 0;

  // Even evicting every eligible candidate must make the demand fit.
  std::vector<int32_t> all(ncand);
  for (int32_t i = 0; i < ncand; i++) all[i] = i;
  if (!vs.feasible(all.data(), ncand, freed_off, freed_idx, freed_amt))
    return 0;  // mode 0: infeasible

  if (ncand <= max_exh_cands) {
    int32_t max_size = std::min(ncand, max_exh_size);
    std::vector<int32_t> combo(max_size);
    std::vector<int32_t> best(max_size);
    for (int32_t size = 1; size <= max_size; size++) {
      bool have_best = false;
      int64_t best_prio = 0, best_chips = 0;
      // Lexicographic combination enumeration — the itertools order the
      // Python search iterates, so strict-less keeps the same winner.
      for (int32_t i = 0; i < size; i++) combo[i] = i;
      while (true) {
        if (vs.feasible(combo.data(), size, freed_off, freed_idx,
                        freed_amt)) {
          int64_t prio = 0, chp = 0;
          for (int32_t j = 0; j < size; j++) {
            prio += cand_prio[combo[j]];
            chp += cand_chips[combo[j]];
          }
          bool better = false;
          if (!have_best) better = true;
          else if (prio != best_prio) better = prio < best_prio;
          else if (chp != best_chips) better = chp < best_chips;
          else {
            // tuple-of-names tiebreak via the rank column
            for (int32_t j = 0; j < size; j++) {
              int32_t ra = cand_rank[combo[j]], rb = cand_rank[best[j]];
              if (ra != rb) { better = ra < rb; break; }
            }
          }
          if (better) {
            have_best = true;
            best_prio = prio;
            best_chips = chp;
            for (int32_t j = 0; j < size; j++) best[j] = combo[j];
          }
        }
        // advance
        int32_t i = size - 1;
        while (i >= 0 && combo[i] == ncand - size + i) i--;
        if (i < 0) break;
        combo[i]++;
        for (int32_t j = i + 1; j < size; j++) combo[j] = combo[j - 1] + 1;
      }
      if (have_best) {
        for (int32_t j = 0; j < size; j++) out_sel[j] = best[j];
        out_info[0] = 1;
        out_info[1] = size;
        out_info[2] = best_prio;
        out_info[3] = best_chips;
        return size;
      }
    }
  }

  // Greedy: add cheapest-first until feasible (guaranteed — the full set
  // is), then prune most-expensive-first keeping feasibility.
  std::vector<int32_t> chosen;
  for (int32_t c = 0; c < ncand; c++) {
    chosen.push_back(c);
    if (vs.feasible(chosen.data(), (int32_t)chosen.size(), freed_off,
                    freed_idx, freed_amt))
      break;
  }
  std::vector<int32_t> prune(chosen);
  std::sort(prune.begin(), prune.end(), [&](int32_t a, int32_t b) {
    if (cand_prio[a] != cand_prio[b]) return cand_prio[a] > cand_prio[b];
    if (cand_chips[a] != cand_chips[b]) return cand_chips[a] > cand_chips[b];
    return cand_rank[a] < cand_rank[b];
  });
  std::vector<int32_t> trial;
  for (int32_t c : prune) {
    if (chosen.size() <= 1) break;
    trial.clear();
    for (int32_t x : chosen)
      if (x != c) trial.push_back(x);
    if (vs.feasible(trial.data(), (int32_t)trial.size(), freed_off,
                    freed_idx, freed_amt))
      chosen = trial;
  }
  for (size_t j = 0; j < chosen.size(); j++) out_sel[j] = chosen[j];
  out_info[0] = 2;
  out_info[1] = (int64_t)chosen.size();
  return (int32_t)chosen.size();
}
