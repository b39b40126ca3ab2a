// Connect-4 strong solver (from scratch).
//
// The framework's oracle component (the PyTorch port's own copy of the JAX
// package's solver, built and loaded by solver/__init__.py), replacing the
// reference's vendored PascalPons binary (provenance noted at
// c4_exact_solver.py:10-13). Same score convention and a CLI speaking the same
// line protocol (c4_exact_solver.py:28-47), plus a C API for ctypes batch
// solving directly from bitboards.
//
// Techniques (all standard/public): bitboard with (HEIGHT+1) bits per column,
// alpha-beta negamax on the score bound, immediate-win and forced-block
// shortcuts, non-losing move masks, winning-spot move ordering, transposition
// table of upper bounds, iterative null-window search at the root.
//
// Score convention (matches the reference solver's output): 0 = draw under
// perfect play; positive = current player wins, magnitude = (W*H + 2 -
// total_plies_at_win) / 2 (win on the earliest stone scores highest); negative
// symmetric for losses. Empty 7x6 board solves to +1.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <chrono>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace c4 {

constexpr int WIDTH = 7;
constexpr int HEIGHT = 6;
constexpr int AREA = WIDTH * HEIGHT;
constexpr int MIN_SCORE = -AREA / 2 + 3;
constexpr int MAX_SCORE = (AREA + 1) / 2 - 3;
// TT bound-kind encoding split: upper bounds occupy [1, BOUND_OFFSET),
// fail-high lower bounds [BOUND_OFFSET, 127] (scores span ~43 values).
constexpr int BOUND_OFFSET = 64;

using bb = uint64_t;

// Column c occupies bits [c*(H+1), c*(H+1)+H]; bit r within a column is the
// r-th cell from the bottom; the extra top bit stays empty (carry guard).
constexpr int COL_BITS = HEIGHT + 1;

constexpr bb bottom_mask_col(int col) { return bb(1) << (col * COL_BITS); }
constexpr bb top_mask_col(int col) {
  return bb(1) << (HEIGHT - 1 + col * COL_BITS);
}
constexpr bb column_mask(int col) {
  return ((bb(1) << HEIGHT) - 1) << (col * COL_BITS);
}

constexpr bb full_bottom() {
  bb b = 0;
  for (int c = 0; c < WIDTH; ++c) b |= bottom_mask_col(c);
  return b;
}
constexpr bb BOTTOM = full_bottom();
constexpr bb BOARD_MASK = BOTTOM * ((bb(1) << HEIGHT) - 1);

inline int popcount(bb x) { return __builtin_popcountll(x); }

// All cells where `pos` already has three aligned with an empty-able spot —
// i.e. the squares that would complete four-in-a-row for `pos`.
inline bb winning_spots(bb pos, bb mask) {
  // vertical
  bb r = (pos << 1) & (pos << 2) & (pos << 3);
  // horizontal and diagonals: shifts H (diag /), H+1 (horiz), H+2 (diag \)
  for (int dir : {COL_BITS - 1, COL_BITS, COL_BITS + 1}) {
    bb p = (pos << dir) & (pos << 2 * dir);
    r |= p & (pos << 3 * dir);
    r |= p & (pos >> dir);
    p = (pos >> dir) & (pos >> 2 * dir);
    r |= p & (pos >> 3 * dir);
    r |= p & (pos << dir);
  }
  return r & (BOARD_MASK ^ mask);
}

inline bool has_won(bb pos) {
  // Four aligned in any of the four directions.
  for (int dir : {1, COL_BITS - 1, COL_BITS, COL_BITS + 1}) {
    bb m = pos & (pos >> dir);
    if (m & (m >> 2 * dir)) return true;
  }
  return false;
}

struct Position {
  bb current = 0;  // stones of the side to move
  bb mask = 0;     // all stones
  int moves = 0;   // plies played

  bool can_play(int col) const { return (mask & top_mask_col(col)) == 0; }

  void play(int col) {
    current ^= mask;                       // switch perspective
    mask |= mask + bottom_mask_col(col);   // drop a stone in col
    ++moves;
  }

  void play_move_bit(bb move) {
    current ^= mask;
    mask |= move;
    ++moves;
  }

  bool is_winning_move(int col) const {
    return winning_spots(current, mask) & column_mask(col) &
           (mask + bottom_mask_col(col));
  }

  // Playable cells (one per non-full column).
  bb possible() const { return (mask + BOTTOM) & BOARD_MASK; }

  // Opponent squares that win for them immediately.
  bb opponent_winning_spots() const {
    return winning_spots(current ^ mask, mask);
  }

  // Moves that do not hand the opponent an immediate win.
  bb possible_non_losing_moves() const {
    bb poss = possible();
    bb opp_win = opponent_winning_spots();
    bb forced = poss & opp_win;
    if (forced) {
      if (forced & (forced - 1)) return 0;  // two threats: lost
      poss = forced;                        // must block
    }
    return poss & ~(opp_win >> 1);  // never play just below a winning spot
  }

  bool can_win_now() const {
    return winning_spots(current, mask) & possible();
  }

  bb key() const { return current + mask + BOTTOM; }

  // Move quality for ordering: threats created by playing `move`.
  int move_score(bb move) const {
    return popcount(winning_spots(current | move, mask));
  }
};

// Reflect a bitboard left-right (column c <-> WIDTH-1-c).
inline bb mirror_bits(bb x) {
  bb r = 0;
  for (int c = 0; c < WIDTH; ++c) {
    bb col = (x >> (c * COL_BITS)) & ((bb(1) << COL_BITS) - 1);
    r |= col << ((WIDTH - 1 - c) * COL_BITS);
  }
  return r;
}

// Canonical key under the left-right symmetry of the game.
inline bb canonical_key(bb current, bb mask) {
  bb k = current + mask + BOTTOM;
  bb km = mirror_bits(current) + mirror_bits(mask) + BOTTOM;
  return k < km ? k : km;
}

// Opening book: exact strong scores for every position up to a fixed depth,
// keyed by the mirror-canonical position key. Replaces the capability of the
// reference's vendored 7x6.book (a stripped large blob; loaded via the
// PascalPons CLI's -b flag, c4_exact_solver.py:28-32) with a from-scratch
// format: frontier positions at `depth` are solved exactly, interior scores
// derive by negamax backup, entries are (uint64 key, int8 score) sorted.
class Book {
 public:
  int depth = -1;  // max plies covered; -1 = no book loaded

  bool load(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    char magic[4];
    uint8_t meta[4];
    uint64_t count = 0;
    if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "C4BK", 4) ||
        std::fread(meta, 1, 4, f) != 4 ||  // version, width, height, depth
        meta[0] != 1 || meta[1] != WIDTH || meta[2] != HEIGHT ||
        std::fread(&count, 8, 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    keys_.resize(count);
    scores_.resize(count);
    bool ok = std::fread(keys_.data(), 8, count, f) == count &&
              std::fread(scores_.data(), 1, count, f) == count;
    std::fclose(f);
    if (!ok) {
      keys_.clear();
      scores_.clear();
      return false;
    }
    depth = meta[3];
    return true;
  }

  bool save(const char* path) const {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    uint8_t meta[4] = {1, WIDTH, HEIGHT, uint8_t(depth)};
    uint64_t count = keys_.size();
    bool ok = std::fwrite("C4BK", 1, 4, f) == 4 &&
              std::fwrite(meta, 1, 4, f) == 4 &&
              std::fwrite(&count, 8, 1, f) == 1 &&
              std::fwrite(keys_.data(), 8, count, f) == count &&
              std::fwrite(scores_.data(), 1, count, f) == count;
    std::fclose(f);
    return ok;
  }

  // Exact score if the position is in the book; INT_MIN-ish sentinel if not.
  static constexpr int MISS = -128;
  int probe(const Position& p) const {
    bb key = canonical_key(p.current, p.mask);
    auto it = std::lower_bound(keys_.begin(), keys_.end(), key);
    if (it == keys_.end() || *it != key) return MISS;
    return scores_[it - keys_.begin()];
  }

  void set_entries(std::vector<std::pair<bb, int8_t>>& entries, int d) {
    std::sort(entries.begin(), entries.end());
    keys_.resize(entries.size());
    scores_.resize(entries.size());
    for (size_t i = 0; i < entries.size(); ++i) {
      keys_[i] = entries[i].first;
      scores_[i] = entries[i].second;
    }
    depth = d;
  }

  size_t size() const { return keys_.size(); }

 private:
  std::vector<bb> keys_;
  std::vector<int8_t> scores_;
};

// Transposition table of score upper bounds: fixed-size, lossy overwrite.
// The entry count must be coprime with 2^32 (prime here) so that storing the
// truncated 32-bit key is collision-free by the Chinese remainder theorem:
// two keys sharing both (key % size) and (key % 2^32) would have to differ
// by a multiple of size * 2^32 > the 49-bit key space.
class Table {
 public:
  explicit Table(size_t entries = 8388617 /* prime > 2^23 */)
      : size_(entries), keys_(size_, 0), vals_(size_, 0) {}

  void reset() {
    std::fill(keys_.begin(), keys_.end(), 0);
    std::fill(vals_.begin(), vals_.end(), 0);
  }

  void put(bb key, int8_t val) {
    size_t i = index(key);
    keys_[i] = uint32_t(key);  // truncated key; size > 2^32/size collisions ok
    vals_[i] = val;
  }

  int get(bb key) const {
    size_t i = index(key);
    return keys_[i] == uint32_t(key) ? vals_[i] : 0;
  }

 private:
  size_t index(bb key) const { return key % size_; }
  size_t size_;
  std::vector<uint32_t> keys_;
  std::vector<int8_t> vals_;
};

class Solver {
 public:
  uint64_t nodes = 0;

  Solver() = default;
  // tt_entries must be prime (Table's CRT key-truncation argument).
  explicit Solver(size_t tt_entries) : table_(tt_entries) {}

  // Negamax with alpha-beta over score bounds; assumes the side to move
  // cannot win this ply (checked by callers) and nobody has won yet.
  int negamax(const Position& p, int alpha, int beta) {
    ++nodes;
    if (book_ && p.moves <= book_->depth) {
      if (int s = book_->probe(p); s != Book::MISS) return s;
    }
    bb next = p.possible_non_losing_moves();
    if (next == 0)  // every move loses
      return -(AREA - p.moves) / 2;
    if (p.moves >= AREA - 2)  // board fills before anyone can win
      return 0;

    int min = -(AREA - 2 - p.moves) / 2;  // opponent can't win before then
    if (alpha < min) {
      alpha = min;
      if (alpha >= beta) return alpha;
    }
    int max = (AREA - 1 - p.moves) / 2;  // we can't win before then
    // TT entries are keyed on the mirror-canonical position (scores are
    // left-right symmetric) and encode either bound kind: values in
    // [1, BOUND_OFFSET) are upper bounds, values >= BOUND_OFFSET are lower
    // bounds from fail-high cutoffs (offset-encoded).
    bb tkey = canonical_key(p.current, p.mask);
    if (int cached = table_.get(tkey); cached) {
      if (cached >= BOUND_OFFSET) {  // lower bound
        int lo = cached - BOUND_OFFSET + MIN_SCORE - 1;
        if (alpha < lo) {
          alpha = lo;
          if (alpha >= beta) return alpha;
        }
      } else {
        max = cached + MIN_SCORE - 1;
      }
    }
    if (beta > max) {
      beta = max;
      if (alpha >= beta) return beta;
    }

    // Order moves: static centre-first order, then by threats created.
    struct Entry { bb move; int score; };
    Entry entries[WIDTH];
    int n = 0;
    for (int i = 0; i < WIDTH; ++i) {
      int col = ORDER[i];
      if (bb move = next & column_mask(col)) {
        entries[n].move = move;
        entries[n].score = p.move_score(move);
        ++n;
      }
    }
    // Stable insertion sort descending by score (keeps centre-first ties).
    for (int i = 1; i < n; ++i) {
      Entry e = entries[i];
      int j = i;
      while (j > 0 && entries[j - 1].score < e.score) {
        entries[j] = entries[j - 1];
        --j;
      }
      entries[j] = e;
    }

    for (int i = 0; i < n; ++i) {
      Position q = p;
      q.play_move_bit(entries[i].move);
      int score = -negamax(q, -beta, -alpha);
      if (score >= beta) {
        table_.put(tkey, int8_t(score - MIN_SCORE + 1 + BOUND_OFFSET));
        return score;
      }
      if (score > alpha) alpha = score;
    }
    table_.put(tkey, int8_t(alpha - MIN_SCORE + 1));
    return alpha;
  }

  // Full-strength solve with iterative null-window narrowing.
  int solve(const Position& p) {
    if (book_ && p.moves <= book_->depth) {
      if (int s = book_->probe(p); s != Book::MISS) return s;
    }
    if (p.can_win_now()) return (AREA + 1 - p.moves) / 2;
    int min = -(AREA - p.moves) / 2;
    int max = (AREA + 1 - p.moves) / 2;
    while (min < max) {
      int med = min + (max - min) / 2;
      if (med <= 0 && min / 2 < med) med = min / 2;
      else if (med >= 0 && max / 2 > med) med = max / 2;
      int r = negamax(p, med, med + 1);  // null-window: compare to med
      if (r <= med) max = r;
      else min = r;
    }
    return min;
  }

  void reset() { table_.reset(); }

  void set_book(const Book* book) { book_ = book; }

 private:
  static constexpr int ORDER[WIDTH] = {3, 2, 4, 1, 5, 0, 6};
  Table table_;
  const Book* book_ = nullptr;
};

// Build a depth-D book: BFS-enumerate the mirror-canonical reachable
// positions level by level, exactly solve only the depth-D frontier (one
// shared transposition table across solves), then derive every interior
// score by pure negamax backup over the level below.
inline Book* generate_book(int depth, bool verbose = false) {
  std::vector<std::vector<Position>> levels(depth + 1);
  std::unordered_set<bb> seen;
  levels[0].push_back(Position{});
  seen.insert(canonical_key(0, 0));
  for (int d = 0; d < depth; ++d) {
    for (const Position& p : levels[d]) {
      for (int col = 0; col < WIDTH; ++col) {
        if (!p.can_play(col) || p.is_winning_move(col)) continue;
        Position q = p;
        q.play(col);
        bb key = canonical_key(q.current, q.mask);
        if (seen.insert(key).second) levels[d + 1].push_back(q);
      }
    }
    if (verbose)
      std::fprintf(stderr, "book: depth %d has %zu canonical positions\n",
                   d + 1, levels[d + 1].size());
  }

  // Scores per level, keyed by canonical key.
  std::vector<std::unordered_map<bb, int>> scores(depth + 1);
  // A book-sized TT (prime > 2^26, ~340 MB): the frontier solves share
  // enormous amounts of subtree work, which the default 8M-entry table
  // thrashes away.
  Solver solver(67108879);
  size_t done = 0;
  for (const Position& p : levels[depth]) {
    scores[depth][canonical_key(p.current, p.mask)] = solver.solve(p);
    if (verbose && ++done % 1000 == 0)
      std::fprintf(stderr, "book: frontier %zu/%zu (%llu nodes)\n", done,
                   levels[depth].size(), (unsigned long long)solver.nodes);
  }
  for (int d = depth - 1; d >= 0; --d) {
    for (const Position& p : levels[d]) {
      int best = -AREA;
      for (int col = 0; col < WIDTH; ++col) {
        if (!p.can_play(col)) continue;
        int cand;
        if (p.is_winning_move(col)) {
          cand = (AREA + 1 - p.moves) / 2;  // earliest win = max score
        } else {
          Position q = p;
          q.play(col);
          cand = -scores[d + 1].at(canonical_key(q.current, q.mask));
        }
        if (cand > best) best = cand;
      }
      scores[d][canonical_key(p.current, p.mask)] = best;
    }
  }

  std::vector<std::pair<bb, int8_t>> entries;
  for (auto& level : scores)
    for (auto& [key, score] : level) entries.emplace_back(key, int8_t(score));
  Book* book = new Book();
  book->set_entries(entries, depth);
  return book;
}

// Parse a 1-indexed move string ("4453..."); returns false on illegal input
// or if the game already ended mid-sequence.
inline bool setup(Position& p, const char* moves) {
  p = Position{};
  for (const char* c = moves; *c; ++c) {
    if (*c < '1' || *c > '0' + WIDTH) return false;
    int col = *c - '1';
    if (!p.can_play(col)) return false;
    if (p.is_winning_move(col)) return false;  // finished games unsupported
    p.play(col);
  }
  return true;
}

}  // namespace c4

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* c4_new() { return new c4::Solver(); }

void c4_free(void* solver) { delete static_cast<c4::Solver*>(solver); }

void c4_reset(void* solver) { static_cast<c4::Solver*>(solver)->reset(); }

// Solve a position given as a move string; returns the score, or -128 on
// invalid input (illegal/finished sequence).
int c4_solve_moves(void* solver, const char* moves) {
  c4::Position p;
  if (!c4::setup(p, moves)) return -128;
  return static_cast<c4::Solver*>(solver)->solve(p);
}

// Solve directly from bitboards (current-player stones + occupancy mask),
// bit layout: bit = col * (HEIGHT+1) + row, row 0 = bottom. `plies` = stones
// on the board. Assumes a legal, unfinished position.
int c4_solve_bitboard(void* solver, uint64_t current, uint64_t mask,
                      int plies) {
  if (c4::has_won(current) || c4::has_won(current ^ mask)) return -128;
  c4::Position p;
  p.current = current;
  p.mask = mask;
  p.moves = plies;
  return static_cast<c4::Solver*>(solver)->solve(p);
}

// Batch interface: scores[i] = score of the i-th '\n'-free move string.
void c4_solve_batch(void* solver, const char** moves, int n, int* scores) {
  for (int i = 0; i < n; ++i) scores[i] = c4_solve_moves(solver, moves[i]);
}

uint64_t c4_nodes(void* solver) {
  return static_cast<c4::Solver*>(solver)->nodes;
}

// Load an opening book and attach it to the solver; returns the book depth,
// or -1 on failure. The book handle is owned by the solver wrapper side:
// call c4_book_free when done (after freeing the solver).
void* c4_book_load(const char* path) {
  auto* book = new c4::Book();
  if (!book->load(path)) {
    delete book;
    return nullptr;
  }
  return book;
}

void c4_book_free(void* book) { delete static_cast<c4::Book*>(book); }

int c4_book_depth(void* book) { return static_cast<c4::Book*>(book)->depth; }

uint64_t c4_book_size(void* book) {
  return static_cast<c4::Book*>(book)->size();
}

void c4_set_book(void* solver, void* book) {
  static_cast<c4::Solver*>(solver)->set_book(static_cast<c4::Book*>(book));
}

// Generate a depth-D book and write it to `path`; returns entry count or 0.
uint64_t c4_book_generate(int depth, const char* path) {
  c4::Book* book = c4::generate_book(depth);
  uint64_t n = book->save(path) ? book->size() : 0;
  delete book;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CLI: line-per-position stdin/stdout protocol compatible with the reference
// wrapper (c4_exact_solver.py:28-47): for each input line of 1-indexed moves,
// print "<moves> <score> <nodes> <time_us>". Flags:
//   -b <book>        use an opening book (reference CLI's flag)
//   -g <depth> <out> generate a depth-<depth> book, write it, and exit
// ---------------------------------------------------------------------------

#ifdef C4_CLI
int main(int argc, char** argv) {
  c4::Solver solver;
  c4::Book book;
  for (int i = 1; i < argc; ++i) {
    if (!std::strcmp(argv[i], "-b") && i + 1 < argc) {
      if (book.load(argv[i + 1])) {
        solver.set_book(&book);
        std::fprintf(stderr, "Loaded book %s: depth %d, %zu entries\n",
                     argv[i + 1], book.depth, book.size());
      } else {
        std::fprintf(stderr, "Could not load book %s\n", argv[i + 1]);
      }
      ++i;
    } else if (!std::strcmp(argv[i], "-g") && i + 2 < argc) {
      int depth = std::atoi(argv[i + 1]);
      auto t0 = std::chrono::steady_clock::now();
      c4::Book* generated = c4::generate_book(depth, /*verbose=*/true);
      auto secs = std::chrono::duration_cast<std::chrono::seconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
      bool ok = generated->save(argv[i + 2]);
      std::fprintf(stderr, "Generated depth-%d book: %zu entries in %llds%s\n",
                   depth, generated->size(), (long long)secs,
                   ok ? "" : " (WRITE FAILED)");
      delete generated;
      return ok ? 0 : 1;
    }
  }
  std::string line;
  char buf[256];
  while (std::fgets(buf, sizeof(buf), stdin)) {
    line = buf;
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    c4::Position p;
    if (!c4::setup(p, line.c_str())) {
      std::fprintf(stderr, "Invalid position: %s\n", line.c_str());
      continue;
    }
    solver.nodes = 0;
    auto t0 = std::chrono::steady_clock::now();
    int score = solver.solve(p);
    auto us = std::chrono::duration_cast<std::chrono::microseconds>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
    std::printf("%s %d %llu %lld\n", line.c_str(), score,
                (unsigned long long)solver.nodes, (long long)us);
  }
  return 0;
}
#endif
