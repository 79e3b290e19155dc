/* Ladder reading: recursive capture/escape search on a scalar board.
 *
 * Native counterpart of the reference's ladder solver
 * (upstream `src_cpp/elfgames/go/base/board.cc:300-521`
 * checkLadderUseSearch + checkLadder, board.h:392): given a position,
 * decide whether a victim's escape move runs into a working ladder
 * (capturer chases the 2-liberty group across the board and captures
 * it), or whether a capturer's atari move starts one.  The search plays
 * forced moves for both sides — the capturer blocks the escape with
 * fewer follow-up liberties (branching only when both blocks look
 * equal, bounded by MAX_LADDER_CALLS), the victim always extends out of
 * atari — and returns the capture depth, 0 if the ladder fails.
 *
 * This is host-side tactical reading (scalar recursion with rare
 * branching), so like the reference it lives in native code, not in the
 * vectorized device engine.
 *
 * Built at first use by elf_tpu_torch/_build.py (the host C compiler).
 * API (ctypes), boards int8 n2 (0 empty / 1 black / 2 white):
 *   int ladder_escape_depth(int size, const int8_t* stones,
 *                           int ko_point, int ko_color,
 *                           int move, int victim_color);
 *     == reference checkLadder: would `victim_color` playing `move`
 *     (rescuing its atari'd neighbor group, ending on 2 liberties next
 *     to one strong enemy group) be ladder-captured?  Returns depth>0.
 *   int ladder_capture_depth(int size, const int8_t* stones,
 *                            int ko_point, int ko_color,
 *                            int move, int capturer_color);
 *     does `capturer_color` playing `move` put an adjacent enemy group
 *     in atari whose escape is ladder-doomed?  Returns depth>0.
 */

#include <stdint.h>
#include <string.h>

#define MAX_N 25
#define MAX_N2 (MAX_N * MAX_N)
#define MAX_LADDER_CALLS 1024
#define PASS_MOVE (-1)

typedef struct {
  int size, n2;
  int8_t stones[MAX_N2];
  int ko_point;  /* retake forbidden here ... */
  int ko_color;  /* ... for this color */
  int last_move;
  int last_move2;
  int next_player;
} LBoard;

/* Neighbor order matches the reference's FOR4 delta4 = {-1, -stride,
 * +1, +stride} = left, up, right, down (board.h:220) — the order drives
 * escape[] collection and the victim's flee choice, so parity with the
 * reference's search requires the same traversal. */
static int nbrs_of(const LBoard *b, int p, int *out) {
  int size = b->size, n = 0;
  int r = p / size, c = p % size;
  if (c > 0) out[n++] = p - 1;
  if (r > 0) out[n++] = p - size;
  if (c < size - 1) out[n++] = p + 1;
  if (r < size - 1) out[n++] = p + size;
  return n;
}

/* Flood the chain containing `start`; fills group[] (count returned),
 * marks seen[], counts DISTINCT liberties into *libs (liberty points are
 * marked in seen with value 2 so each counts once). */
static int group_libs(const LBoard *b, int start, uint8_t *seen, int *group,
                      int *libs) {
  int color = b->stones[start];
  int stack[MAX_N2], top = 0, count = 0;
  *libs = 0;
  stack[top++] = start;
  seen[start] = 1;
  while (top > 0) {
    int p = stack[--top];
    group[count++] = p;
    int nb[4], nn = nbrs_of(b, p, nb);
    for (int i = 0; i < nn; i++) {
      int q = nb[i];
      if (b->stones[q] == 0) {
        if (seen[q] != 2) {
          seen[q] = 2;
          (*libs)++;
        }
      } else if (b->stones[q] == color && !seen[q]) {
        seen[q] = 1;
        stack[top++] = q;
      }
    }
  }
  return count;
}

static int libs_at(const LBoard *b, int p) {
  uint8_t seen[MAX_N2];
  int group[MAX_N2], libs;
  memset(seen, 0, (size_t)b->n2);
  group_libs(b, p, seen, group, &libs);
  return libs;
}

/* Play `move` for b->next_player with captures + simple-ko bookkeeping.
 * Returns 0 if illegal (occupied / ko retake / suicide), 1 on success. */
static int lboard_play(LBoard *b, int move) {
  int color = b->next_player, opp = 3 - color;
  if (move < 0 || move >= b->n2 || b->stones[move] != 0) return 0;
  if (move == b->ko_point && color == b->ko_color) return 0;
  b->stones[move] = (int8_t)color;
  int captured = 0, cap_pt = -1;
  int nb[4], nn = nbrs_of(b, move, nb);
  for (int i = 0; i < nn; i++) {
    int q = nb[i];
    if (b->stones[q] != opp) continue;
    uint8_t seen[MAX_N2];
    int group[MAX_N2], libs;
    memset(seen, 0, (size_t)b->n2);
    int cnt = group_libs(b, q, seen, group, &libs);
    if (libs == 0) {
      for (int j = 0; j < cnt; j++) b->stones[group[j]] = 0;
      captured += cnt;
      cap_pt = group[0];
    }
  }
  if (libs_at(b, move) == 0) { /* suicide: retract */
    b->stones[move] = 0;
    /* captures cannot have happened if we have no liberties now */
    return 0;
  }
  /* simple ko: lone new stone, one liberty, captured exactly one */
  b->ko_point = -1;
  b->ko_color = 0;
  if (captured == 1) {
    int own_nbr = 0, empty_nbr = 0;
    for (int i = 0; i < nn; i++) {
      if (b->stones[nb[i]] == color) own_nbr++;
      if (b->stones[nb[i]] == 0) empty_nbr++;
    }
    if (own_nbr == 0 && empty_nbr == 1) {
      b->ko_point = cap_pt;
      b->ko_color = opp;
    }
  }
  b->last_move2 = b->last_move;
  b->last_move = move;
  b->next_player = opp;
  return 1;
}

/* The alternating forced-move search (checkLadderUseSearch).  `victim`
 * is the fleeing color; on entry the victim's group head is at
 * last_move (victim just fled) or the capturer just blocked. */
static int ladder_search(LBoard *b, int victim, int *num_call, int depth) {
  ++(*num_call);
  if (*num_call > 64 * MAX_LADDER_CALLS) return 0; /* runaway guard; the
    must_block fallback at MAX_LADDER_CALLS already linearizes search */
  int c = b->last_move, c2 = b->last_move2;
  if (c < 0) return 0;
  int lib = libs_at(b, c);

  if (victim != b->next_player) {
    /* Capturer to play; the victim group head is at c. */
    if (lib == 1) return depth;       /* chase done: captured next */
    if (lib >= 3) return 0;           /* victim broke free */
    int nb[4], nn = nbrs_of(b, c, nb);
    int escape[4], num_escape = 0;
    for (int i = 0; i < nn; i++)
      if (b->stones[nb[i]] == 0) escape[num_escape++] = nb[i];
    if (num_escape <= 1) return 0;    /* liberties not adjacent: no shape */
    /* Block the escape whose follow-up would give the victim 3 libs. */
    int must_block = PASS_MOVE;
    for (int i = 0; i < 2; i++) {
      int nb2[4], nn2 = nbrs_of(b, escape[i], nb2), freedom = 0;
      for (int j = 0; j < nn2; j++)
        if (b->stones[nb2[j]] == 0) freedom++;
      if (freedom == 3) { must_block = escape[i]; break; }
    }
    if (must_block == PASS_MOVE && *num_call >= MAX_LADDER_CALLS)
      must_block = escape[0];
    if (must_block != PASS_MOVE) {
      if (lboard_play(b, must_block)) {
        int d = ladder_search(b, victim, num_call, depth + 1);
        if (d > 0) return d;
      }
    } else {
      /* Rare: both blocks plausible — try each on its own board. */
      LBoard b2 = *b;
      if (lboard_play(&b2, escape[0])) {
        int d = ladder_search(&b2, victim, num_call, depth + 1);
        if (d > 0) return d;
      }
      if (lboard_play(b, escape[1])) {
        int d = ladder_search(b, victim, num_call, depth + 1);
        if (d > 0) return d;
      }
    }
  } else {
    /* Victim to play; c is the capturer's block, c2 the victim's head. */
    if (lib == 1) return 0;           /* capturer self-atari: escape */
    int nb[4], nn = nbrs_of(b, c2, nb);
    int flee = PASS_MOVE;
    for (int i = 0; i < nn; i++)
      if (b->stones[nb[i]] == 0) { flee = nb[i]; break; }
    if (flee == PASS_MOVE) return 0;  /* malformed: treat as escaped */
    if (!lboard_play(b, flee)) return 0;
    int flee_libs = libs_at(b, flee);
    if (flee_libs >= 3) return 0;     /* out of the ladder */
    if (flee_libs == 2) {
      /* counter-atari available: an adjacent capturer group in atari */
      int nb2[4], nn2 = nbrs_of(b, flee, nb2);
      for (int i = 0; i < nn2; i++) {
        int q = nb2[i];
        if (b->stones[q] == 3 - victim && libs_at(b, q) == 1) return 0;
      }
    }
    int d = ladder_search(b, victim, num_call, depth + 1);
    if (d > 0) return d;
  }
  return 0;
}

static void lboard_init(LBoard *b, int size, const int8_t *stones,
                        int ko_point, int ko_color, int next_player) {
  b->size = size;
  b->n2 = size * size;
  memcpy(b->stones, stones, (size_t)b->n2);
  b->ko_point = ko_point;
  b->ko_color = ko_color;
  b->last_move = PASS_MOVE;
  b->last_move2 = PASS_MOVE;
  b->next_player = next_player;
}

int ladder_escape_depth(int size, const int8_t *stones, int ko_point,
                        int ko_color, int move, int victim_color) {
  if (size <= 0 || size > MAX_N) return 0;
  if (victim_color != 1 && victim_color != 2) return 0;
  LBoard b;
  lboard_init(&b, size, stones, ko_point, ko_color, victim_color);
  if (move < 0 || move >= b.n2 || b.stones[move] != 0) return 0;

  /* Preconditions (checkLadder, board.cc:475): the move has exactly two
   * empty neighbors, exactly one adjacent own group which is in atari,
   * and exactly one adjacent enemy group, with >= 3 liberties. */
  int nb[4], nn = nbrs_of(&b, move, nb);
  int empty_nbrs = 0;
  for (int i = 0; i < nn; i++)
    if (b.stones[nb[i]] == 0) empty_nbrs++;
  if (empty_nbrs != 2) return 0;

  uint8_t in_group[MAX_N2];
  memset(in_group, 0, (size_t)b.n2);
  int num_enemy = 0, num_self = 0;
  int one_enemy_three = 0, one_in_atari = 0;
  for (int i = 0; i < nn; i++) {
    int q = nb[i];
    if (b.stones[q] == 0 || in_group[q]) continue;
    uint8_t seen[MAX_N2];
    int group[MAX_N2], libs;
    memset(seen, 0, (size_t)b.n2);
    int cnt = group_libs(&b, q, seen, group, &libs);
    for (int j = 0; j < cnt; j++) in_group[group[j]] = 1;
    if (b.stones[q] == victim_color) {
      one_in_atari = (num_self == 0 && libs == 1);
      num_self++;
    } else {
      one_enemy_three = (num_enemy == 0 && libs >= 3);
      num_enemy++;
    }
  }
  if (num_self != 1 || num_enemy != 1) return 0;
  if (!(one_enemy_three && one_in_atari)) return 0;

  if (!lboard_play(&b, move)) return 0;
  int num_call = 0;
  return ladder_search(&b, victim_color, &num_call, 1);
}

int ladder_capture_depth(int size, const int8_t *stones, int ko_point,
                         int ko_color, int move, int capturer_color) {
  if (size <= 0 || size > MAX_N) return 0;
  if (capturer_color != 1 && capturer_color != 2) return 0;
  int victim = 3 - capturer_color;
  LBoard b;
  lboard_init(&b, size, stones, ko_point, ko_color, capturer_color);
  if (!lboard_play(&b, move)) return 0;

  /* Any adjacent victim group now in atari whose single escape is
   * ladder-doomed?  Seed the search as if the victim's head (a group
   * stone adjacent to the liberty) were its last move. */
  int nb[4], nn = nbrs_of(&b, move, nb);
  uint8_t handled[MAX_N2];
  memset(handled, 0, (size_t)b.n2);
  int best = 0;
  for (int i = 0; i < nn; i++) {
    int q = nb[i];
    if (b.stones[q] != victim || handled[q]) continue;
    uint8_t seen[MAX_N2];
    int group[MAX_N2], libs;
    memset(seen, 0, (size_t)b.n2);
    int cnt = group_libs(&b, q, seen, group, &libs);
    for (int j = 0; j < cnt; j++) handled[group[j]] = 1;
    if (libs != 1) continue;
    /* head = a group stone adjacent to the liberty point */
    int head = -1;
    for (int j = 0; j < cnt && head < 0; j++) {
      int nb2[4], nn2 = nbrs_of(&b, group[j], nb2);
      for (int k = 0; k < nn2; k++)
        if (b.stones[nb2[k]] == 0) { head = group[j]; break; }
    }
    if (head < 0) continue;
    LBoard b2 = b;
    b2.last_move2 = head;  /* victim's head; flee from its liberty */
    b2.last_move = move;   /* capturer's atari stone */
    b2.next_player = victim;
    int num_call = 0;
    int d = ladder_search(&b2, victim, &num_call, 1);
    if (d > best) best = d;
  }
  return best;
}
