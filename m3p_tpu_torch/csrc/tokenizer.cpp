// The port's native tokenizer (a copy of the JAX package's
// native/tokenizer.cpp): unigram-LM subword segmentation with
// SentencePiece-compatible semantics behind a C ABI bound with ctypes
// (`m3p_tpu_torch/tokenization/native.py`).  Whitespace pretokenization with
// the U+2581 ("▁") word-boundary marker, Viterbi segmentation maximizing the
// sum of piece log-probabilities, byte-level UTF-8 safe, multithreaded batch
// encoding for the data pipeline.
//
// Model format: UTF-8 TSV, one "<piece>\t<score>[\t<type>]" per line; line
// number = id.  The optional third column is the SentencePiece piece type
// (1=NORMAL default); non-matchable types (UNKNOWN=2/CONTROL=3/UNUSED=5) keep
// their id slot but are excluded from segmentation, so a converted XLM-R
// vocabulary keeps <unk>/<s>/</s> at raw ids 0..2 without ever matching the
// literal strings.  Specials (<s>/<pad>/</s>/<unk>/<mask>) are handled by the
// Python wrapper via the fairseq offset convention.
//
// Built with trainer.cpp into one host library by
// `m3p_tpu_torch/ops/_build.py::build_host` (c++ -O3 -std=c++17 -fPIC
// -shared -lpthread).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr const char* kSpace = "\xe2\x96\x81";  // U+2581 LOWER ONE EIGHTH BLOCK

struct TrieNode {
  std::unordered_map<char, int32_t> next;  // byte -> node index
  int32_t piece_id = -1;                   // valid terminal if >= 0
};

struct Model {
  std::vector<std::string> pieces;
  std::vector<float> scores;
  std::vector<uint8_t> matchable;  // piece participates in segmentation
  std::unordered_map<std::string, int32_t> piece_to_id;
  std::vector<TrieNode> trie;
  float min_score = 0.f;

  void build_trie() {
    trie.clear();
    trie.emplace_back();
    for (int32_t id = 0; id < (int32_t)pieces.size(); ++id) {
      if (!matchable[id]) continue;
      int32_t node = 0;
      for (char c : pieces[id]) {
        auto it = trie[node].next.find(c);
        if (it == trie[node].next.end()) {
          trie[node].next.emplace(c, (int32_t)trie.size());
          node = (int32_t)trie.size();
          trie.emplace_back();
        } else {
          node = it->second;
        }
      }
      trie[node].piece_id = id;
    }
  }
};

int utf8_char_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xe) return 3;
  if ((b >> 3) == 0x1e) return 4;
  return 1;  // invalid byte: treat as single char
}

// Viterbi over the normalized word (already ▁-prefixed).
// Unknown characters fall back to per-character pieces with a penalty.
void viterbi_encode(const Model& m, const std::string& text,
                    std::vector<int32_t>* out) {
  const size_t n = text.size();
  if (n == 0) return;
  const float kUnkPenalty = m.min_score - 10.0f;
  std::vector<float> best(n + 1, -1e30f);
  std::vector<int32_t> back_piece(n + 1, -1);
  std::vector<int32_t> back_pos(n + 1, -1);
  best[0] = 0.f;
  for (size_t i = 0; i < n; ++i) {
    if (best[i] <= -1e29f) continue;
    // walk the trie for all pieces starting at i
    int32_t node = 0;
    for (size_t j = i; j < n; ++j) {
      auto it = m.trie[node].next.find(text[j]);
      if (it == m.trie[node].next.end()) break;
      node = it->second;
      int32_t pid = m.trie[node].piece_id;
      if (pid >= 0) {
        float s = best[i] + m.scores[pid];
        if (s > best[j + 1]) {
          best[j + 1] = s;
          back_piece[j + 1] = pid;
          back_pos[j + 1] = (int32_t)i;
        }
      }
    }
    // unknown fallback: skip one UTF-8 character
    size_t adv = utf8_char_len((unsigned char)text[i]);
    size_t j = std::min(i + adv, n);
    float s = best[i] + kUnkPenalty;
    if (s > best[j]) {
      best[j] = s;
      back_piece[j] = -1;  // unk char
      back_pos[j] = (int32_t)i;
    }
  }
  // backtrack
  std::vector<int32_t> rev;
  size_t pos = n;
  while (pos > 0) {
    int32_t pid = back_piece[pos];
    int32_t prev = back_pos[pos];
    if (prev < 0) {  // should not happen; bail to unk for the whole rest
      rev.push_back(-1);
      break;
    }
    rev.push_back(pid);
    pos = (size_t)prev;
  }
  out->insert(out->end(), rev.rbegin(), rev.rend());
}

// Normalize + pretokenize: split on whitespace, prefix each word with ▁
// (SentencePiece treat-whitespace-as-suffix=false convention).
void encode_text(const Model& m, const char* text, std::vector<int32_t>* out) {
  const char* p = text;
  std::string word;
  auto flush = [&]() {
    if (!word.empty()) {
      std::string norm = std::string(kSpace) + word;
      viterbi_encode(m, norm, out);
      word.clear();
    }
  };
  for (; *p; ++p) {
    unsigned char c = (unsigned char)*p;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush();
    } else {
      word.push_back(*p);
    }
  }
  flush();
}

std::vector<std::unique_ptr<Model>>& models() {
  static std::vector<std::unique_ptr<Model>> m;
  return m;
}
std::mutex g_mu;

}  // namespace

extern "C" {

// Returns a handle (>= 0) or -1 on failure.
int32_t m3ptok_load(const char* path) {
  auto model = std::make_unique<Model>();
  std::ifstream f(path);
  if (!f.is_open()) return -1;
  std::string line;
  float min_score = 0.f;
  bool any_score = false;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    size_t tab = line.find('\t');
    if (tab == std::string::npos) continue;
    std::string piece = line.substr(0, tab);
    size_t tab2 = line.find('\t', tab + 1);
    float score = std::strtof(line.c_str() + tab + 1, nullptr);
    // optional 3rd column: SentencePiece piece type; NORMAL=1/USER_DEFINED=4
    // are matchable, UNKNOWN/CONTROL/UNUSED keep the id slot only
    long type = 1;
    if (tab2 != std::string::npos)
      type = std::strtol(line.c_str() + tab2 + 1, nullptr, 10);
    bool match = (type == 1 || type == 4);
    if (match) {
      model->piece_to_id.emplace(piece, (int32_t)model->pieces.size());
      min_score = any_score ? std::min(min_score, score) : score;
      any_score = true;
    }
    model->matchable.push_back(match ? 1 : 0);
    model->pieces.push_back(std::move(piece));
    model->scores.push_back(score);
  }
  model->min_score = any_score ? min_score : 0.f;
  model->build_trie();
  std::lock_guard<std::mutex> lock(g_mu);
  models().push_back(std::move(model));
  return (int32_t)models().size() - 1;
}

int32_t m3ptok_vocab_size(int32_t handle) {
  return (int32_t)models()[handle]->pieces.size();
}

// Encode one text; returns the number of ids written (<= max_ids).
// Unknown characters produce id -1 (wrapper maps to <unk>).
int32_t m3ptok_encode(int32_t handle, const char* text, int32_t* out_ids,
                      int32_t max_ids) {
  std::vector<int32_t> ids;
  encode_text(*models()[handle], text, &ids);
  int32_t n = std::min((int32_t)ids.size(), max_ids);
  std::memcpy(out_ids, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batch encode with worker threads.  texts: array of C strings.
// out_ids: (n_texts, max_ids) row-major; out_lens: per-row id counts.
void m3ptok_encode_batch(int32_t handle, const char** texts, int32_t n_texts,
                         int32_t* out_ids, int32_t* out_lens, int32_t max_ids,
                         int32_t n_threads) {
  const Model& m = *models()[handle];
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  std::
      vector<int32_t> starts;
  int32_t chunk = (n_texts + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int32_t lo = t * chunk, hi = std::min(n_texts, (t + 1) * chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi]() {
      for (int32_t i = lo; i < hi; ++i) {
        std::vector<int32_t> ids;
        encode_text(m, texts[i], &ids);
        int32_t n = std::min((int32_t)ids.size(), max_ids);
        std::memcpy(out_ids + (size_t)i * max_ids, ids.data(),
                    n * sizeof(int32_t));
        out_lens[i] = n;
      }
    });
  }
  for (auto& w : workers) w.join();
}

// id -> piece string; returns length copied (0 if invalid id).
int32_t m3ptok_id_to_piece(int32_t handle, int32_t id, char* out,
                           int32_t max_len) {
  const Model& m = *models()[handle];
  if (id < 0 || id >= (int32_t)m.pieces.size()) return 0;
  const std::string& p = m.pieces[id];
  int32_t n = std::min((int32_t)p.size(), max_len);
  std::memcpy(out, p.data(), n);
  return n;
}

int32_t m3ptok_piece_to_id(int32_t handle, const char* piece) {
  const Model& m = *models()[handle];
  auto it = m.piece_to_id.find(piece);
  return it == m.piece_to_id.end() ? -1 : it->second;
}

}  // extern "C"
