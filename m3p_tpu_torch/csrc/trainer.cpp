// The port's native unigram-LM trainer (a copy of the JAX package's
// native/trainer.cpp): substring seeding + Viterbi-EM pruning, bit-compatible
// with the Python trainer `m3p_tpu_torch/tokenization/unigram.py::
// train_unigram` (same counts, same double-precision score math, same
// explicit (-count, piece) tie-breaks), so the trained models match piece
// for piece.
//
// Exposed through the same C ABI and library as the encoder (tokenizer.cpp):
//   m3ptok_train(paths, n_paths, out_path, vocab_size, max_piece_len,
//                seed_factor, n_em_iters) -> vocab size or -1.
//
// Differences from Python kept deliberately: words are split on ASCII
// whitespace (Python str.split also splits rare Unicode spaces); corpora
// with exotic whitespace should be normalized offline.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {
namespace trainer {

constexpr const char* kSpace = "\xe2\x96\x81";  // U+2581, the ▁ word marker
constexpr double kUnkPenaltyGap = 10.0;

int u8_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xe) return 3;
  if ((b >> 3) == 0x1e) return 4;
  return 1;
}

// byte offsets of UTF-8 character boundaries: bounds[0]=0 .. bounds[n]=size
std::vector<int32_t> char_bounds(const std::string& s) {
  std::vector<int32_t> b;
  b.push_back(0);
  size_t i = 0;
  while (i < s.size()) {
    i += (size_t)u8_len((unsigned char)s[i]);
    if (i > s.size()) i = s.size();
    b.push_back((int32_t)i);
  }
  return b;
}

struct CountedWord {
  std::string bytes;            // ▁-prefixed word
  std::vector<int32_t> bounds;  // char boundaries
  int64_t count = 0;
};

struct TrainModel {
  std::unordered_map<std::string, int32_t> piece_to_id;
  std::vector<std::string> pieces;
  std::vector<double> scores;
  int32_t max_piece_chars = 1;
  double min_score = 0.0;

  void build(const std::vector<std::pair<std::string, double>>& entries) {
    piece_to_id.clear();
    pieces.clear();
    scores.clear();
    max_piece_chars = 1;
    bool any = false;
    for (const auto& e : entries) {
      piece_to_id.emplace(e.first, (int32_t)pieces.size());
      pieces.push_back(e.first);
      scores.push_back(e.second);
      int32_t n_chars = (int32_t)char_bounds(e.first).size() - 1;
      max_piece_chars = std::max(max_piece_chars, n_chars);
      min_score = any ? std::min(min_score, e.second) : e.second;
      any = true;
    }
    if (!any) min_score = 0.0;
  }
};

// Viterbi over char positions, mirroring unigram.py::UnigramModel._viterbi
// exactly (same strict-> tie resolution, same candidate order, double math).
// Returns piece ids; -1 marks an unknown single character.
void viterbi(const TrainModel& m, const CountedWord& w,
             std::vector<int32_t>* out) {
  const int32_t n = (int32_t)w.bounds.size() - 1;
  if (n <= 0) return;
  std::vector<double> best((size_t)n + 1, -1e30);
  std::vector<int32_t> back_pos((size_t)n + 1, -1);
  std::vector<int32_t> back_piece((size_t)n + 1, -1);
  best[0] = 0.0;
  const double unk_penalty = m.min_score - kUnkPenaltyGap;
  std::string key;
  for (int32_t i = 0; i < n; ++i) {
    if (best[i] <= -1e29) continue;
    const int32_t upper = std::min(n, i + m.max_piece_chars);
    for (int32_t j = i + 1; j <= upper; ++j) {
      key.assign(w.bytes, (size_t)w.bounds[i],
                 (size_t)(w.bounds[j] - w.bounds[i]));
      auto it = m.piece_to_id.find(key);
      if (it != m.piece_to_id.end()) {
        double s = best[i] + m.scores[it->second];
        if (s > best[j]) {
          best[j] = s;
          back_pos[j] = i;
          back_piece[j] = it->second;
        }
      }
    }
    double s = best[i] + unk_penalty;  // unknown single-char fallback
    if (s > best[i + 1]) {
      best[i + 1] = s;
      back_pos[i + 1] = i;
      back_piece[i + 1] = -1;
    }
  }
  std::vector<int32_t> rev;
  int32_t pos = n;
  while (pos > 0) {
    rev.push_back(back_piece[pos]);
    pos = back_pos[pos];
    if (pos < 0) break;  // unreachable by construction
  }
  out->insert(out->end(), rev.rbegin(), rev.rend());
}

// sort helper: (-count, piece) — Python's explicit most-common tie-break
struct ByCountThenPiece {
  bool operator()(const std::pair<std::string, int64_t>& a,
                  const std::pair<std::string, int64_t>& b) const {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;  // byte compare == code-point order in UTF-8
  }
};

int64_t train(const char** paths, int32_t n_paths, const char* out_path,
              int32_t vocab_size, int32_t max_piece_len, int32_t seed_factor,
              int32_t n_em_iters) {
  // 1. count ▁-normalized words
  std::unordered_map<std::string, int64_t> word_count_map;
  for (int32_t p = 0; p < n_paths; ++p) {
    std::ifstream f(paths[p]);
    if (!f.is_open()) return -1;
    std::string line, word;
    while (std::getline(f, line)) {
      word.clear();
      auto flush = [&]() {
        if (!word.empty()) {
          word_count_map[std::string(kSpace) + word] += 1;
          word.clear();
        }
      };
      for (char c : line) {
        unsigned char u = (unsigned char)c;
        if (u == ' ' || u == '\t' || u == '\r' || u == '\v' || u == '\f')
          flush();
        else
          word.push_back(c);
      }
      flush();
    }
  }
  std::vector<CountedWord> words;
  words.reserve(word_count_map.size());
  for (auto& kv : word_count_map) {
    CountedWord w;
    w.bytes = kv.first;
    w.bounds = char_bounds(kv.first);
    w.count = kv.second;
    words.push_back(std::move(w));
  }

  // 2. seed: all single characters (required, never pruned) + the
  //    seed_factor*vocab_size most frequent substrings of char-length
  //    2..max_piece_len
  std::unordered_map<std::string, int64_t> chars, subs;
  for (const auto& w : words) {
    const int32_t n = (int32_t)w.bounds.size() - 1;
    for (int32_t i = 0; i < n; ++i) {
      chars[w.bytes.substr((size_t)w.bounds[i],
                           (size_t)(w.bounds[i + 1] - w.bounds[i]))] +=
          w.count;
      const int32_t upper = std::min(n, i + max_piece_len);
      for (int32_t j = i + 2; j <= upper; ++j) {
        subs[w.bytes.substr((size_t)w.bounds[i],
                            (size_t)(w.bounds[j] - w.bounds[i]))] += w.count;
      }
    }
  }
  std::vector<std::pair<std::string, int64_t>> ranked(subs.begin(),
                                                      subs.end());
  std::sort(ranked.begin(), ranked.end(), ByCountThenPiece());
  const int64_t n_required = (int64_t)chars.size();
  const int64_t n_seed =
      std::max<int64_t>((int64_t)vocab_size * seed_factor - n_required, 0);

  std::vector<std::pair<std::string, int64_t>> seed_counts(chars.begin(),
                                                           chars.end());
  for (int64_t k = 0; k < (int64_t)ranked.size() && k < n_seed; ++k) {
    if (chars.find(ranked[k].first) == chars.end())
      seed_counts.push_back(ranked[k]);
  }
  int64_t total = 0;
  for (const auto& kv : seed_counts) total += kv.second;
  std::vector<std::pair<std::string, double>> entries;
  entries.reserve(seed_counts.size());
  for (const auto& kv : seed_counts)
    entries.emplace_back(kv.first,
                         std::log((double)kv.second / (double)total));

  TrainModel model;
  model.build(entries);

  // 3. EM iterations: Viterbi E-step counts, prune to vocab_size, re-score
  for (int32_t it = 0; it < n_em_iters; ++it) {
    std::unordered_map<std::string, int64_t> new_counts;
    std::vector<int32_t> ids;
    for (const auto& w : words) {
      ids.clear();
      viterbi(model, w, &ids);
      for (int32_t pid : ids)
        if (pid >= 0) new_counts[model.pieces[(size_t)pid]] += w.count;
    }
    int64_t tot = 0;
    for (const auto& kv : new_counts) tot += kv.second;
    if (tot == 0) tot = 1;
    // keep required chars + the most-used pieces up to the budget
    std::vector<std::pair<std::string, int64_t>> by_use(new_counts.begin(),
                                                        new_counts.end());
    std::sort(by_use.begin(), by_use.end(), ByCountThenPiece());
    std::unordered_map<std::string, int8_t> kept;
    for (const auto& kv : chars) kept.emplace(kv.first, 1);
    int64_t budget = (int64_t)vocab_size - n_required;
    for (const auto& kv : by_use) {
      if (budget <= 0) break;
      if (kept.emplace(kv.first, 1).second) --budget;
    }
    entries.clear();
    const double denom = (double)tot + 0.1 * (double)kept.size();
    for (const auto& kv : kept) {
      auto cit = new_counts.find(kv.first);
      const double c = cit == new_counts.end() ? 0.0 : (double)cit->second;
      entries.emplace_back(kv.first, std::log((c + 0.1) / denom));
    }
    model.build(entries);
  }

  // 4. deterministic output order: single chars first, then (-score, piece)
  struct Row {
    std::string piece;
    double score;
    bool multi;
  };
  std::vector<Row> rows;
  rows.reserve(model.pieces.size());
  for (size_t i = 0; i < model.pieces.size(); ++i) {
    const int32_t n_chars =
        (int32_t)char_bounds(model.pieces[i]).size() - 1;
    rows.push_back({model.pieces[i], model.scores[i], n_chars > 1});
  }
  std::sort(rows.begin(), rows.end(), [](const Row& a, const Row& b) {
    if (a.multi != b.multi) return !a.multi;
    if (a.score != b.score) return a.score > b.score;
    return a.piece < b.piece;
  });

  std::FILE* out = std::fopen(out_path, "w");
  if (!out) return -1;
  for (const auto& r : rows)
    std::fprintf(out, "%s\t%.17g\n", r.piece.c_str(), r.score);
  std::fclose(out);
  return (int64_t)rows.size();
}

}  // namespace trainer
}  // namespace

extern "C" {

// Train a unigram vocabulary from text corpora and write the TSV model.
// Returns the trained vocab size, or -1 on IO failure.
int64_t m3ptok_train(const char** paths, int32_t n_paths,
                     const char* out_path, int32_t vocab_size,
                     int32_t max_piece_len, int32_t seed_factor,
                     int32_t n_em_iters) {
  return trainer::train(paths, n_paths, out_path, vocab_size, max_piece_len,
                        seed_factor, n_em_iters);
}

}  // extern "C"
