/* Go game replayer: moves -> per-ply board snapshots.  Host code, the
 * port's own copy of the JAX package's native/replayer.c.
 *
 * Counterpart of the reference's offline record replay
 * (GoStateExtOffline::fromRecord + switchRandomMove, go_state_ext.h:259):
 * the learner reconstructs board positions from compact move-string
 * records.  The whole game is replayed once, when the record enters the
 * replay buffer, and every post-move board is stored, so assembling a
 * training batch is pure array gathering.
 *
 * Only legal move sequences are expected (records come from the engine),
 * so this implements placement + capture (flood fill), not legality.
 *
 * Built by elf_tpu_torch/_build.py (cc -O2 -shared -fPIC).
 * API (ctypes):
 *   int replay_game_ex(int size, const int32_t* moves, int n_moves,
 *                      int first_player,
 *                      const int32_t* setup_black, int n_black,
 *                      const int32_t* setup_white, int n_white,
 *                      int8_t* out_boards)   -- out [n_moves, size*size]
 * starts from pre-placed setup stones (handicap) and lets either color
 * move first.  Returns 0 on success, -1 on bad input.  out_boards[k] is
 * the board AFTER move k (0 empty / 1 black / 2 white); pass == size*size.
 */

#include <stdint.h>
#include <string.h>

#define MAX_N2 (25 * 25)

static int flood_group(int size, const int8_t *board, int start, int color,
                       int *group, uint8_t *seen, int *has_lib) {
  /* Collect the chain containing `start`; sets *has_lib. */
  int n2 = size * size;
  int stack[MAX_N2];
  int top = 0, count = 0;
  *has_lib = 0;
  stack[top++] = start;
  seen[start] = 1;
  while (top > 0) {
    int p = stack[--top];
    group[count++] = p;
    int r = p / size, c = p % size;
    int nbrs[4];
    int nn = 0;
    if (r > 0) nbrs[nn++] = p - size;
    if (r < size - 1) nbrs[nn++] = p + size;
    if (c > 0) nbrs[nn++] = p - 1;
    if (c < size - 1) nbrs[nn++] = p + 1;
    for (int i = 0; i < nn; i++) {
      int q = nbrs[i];
      if (board[q] == 0) {
        *has_lib = 1;
      } else if (board[q] == color && !seen[q]) {
        seen[q] = 1;
        stack[top++] = q;
      }
    }
  }
  return count;
}

int replay_game_ex(int size, const int32_t *moves, int n_moves,
                   int first_player, const int32_t *setup_black, int n_black,
                   const int32_t *setup_white, int n_white,
                   int8_t *out_boards) {
  if (size <= 0 || size > 25 || n_moves < 0) return -1;
  if (first_player != 1 && first_player != 2) return -1;
  int n2 = size * size;
  int8_t board[MAX_N2];
  memset(board, 0, (size_t)n2);
  for (int i = 0; i < n_black; i++) {
    if (setup_black[i] < 0 || setup_black[i] >= n2) return -1;
    board[setup_black[i]] = 1;
  }
  for (int i = 0; i < n_white; i++) {
    if (setup_white[i] < 0 || setup_white[i] >= n2) return -1;
    board[setup_white[i]] = 2;
  }

  for (int k = 0; k < n_moves; k++) {
    int a = moves[k];
    int color = (k % 2 == 0) ? first_player : 3 - first_player;
    int opp = 3 - color;
    if (a < 0 || a > n2) return -1;
    if (a < n2) {
      board[a] = (int8_t)color;
      /* capture adjacent opponent chains with no liberties */
      int r = a / size, c = a % size;
      int nbrs[4];
      int nn = 0;
      if (r > 0) nbrs[nn++] = a - size;
      if (r < size - 1) nbrs[nn++] = a + size;
      if (c > 0) nbrs[nn++] = a - 1;
      if (c < size - 1) nbrs[nn++] = a + 1;
      for (int i = 0; i < nn; i++) {
        int q = nbrs[i];
        if (board[q] == opp) {
          uint8_t seen[MAX_N2];
          int group[MAX_N2];
          memset(seen, 0, (size_t)n2);
          int has_lib = 0;
          int cnt = flood_group(size, board, q, opp, group, seen, &has_lib);
          if (!has_lib) {
            for (int j = 0; j < cnt; j++) board[group[j]] = 0;
          }
        }
      }
      /* suicide should not occur in legal records; clear defensively */
      {
        uint8_t seen[MAX_N2];
        int group[MAX_N2];
        memset(seen, 0, (size_t)n2);
        int has_lib = 0;
        int cnt = flood_group(size, board, a, color, group, seen, &has_lib);
        if (!has_lib) {
          for (int j = 0; j < cnt; j++) board[group[j]] = 0;
        }
      }
    }
    memcpy(out_boards + (size_t)k * n2, board, (size_t)n2);
  }
  return 0;
}
