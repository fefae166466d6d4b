// Greedy graph coloring over a symmetrized CSR pattern, for multicolor
// Gauss-Seidel and SOR (solvers/jacobi.py::greedy_coloring).
//
// The same loop as the JAX package's native helper (its packer.cpp), so the
// port's colors are identical to the reference's: row i takes the smallest
// color not used by a neighbour j != i already colored, where the
// neighbours are the column indices of row i of A and of A^T.  Built with
// g++ -O3 -shared -fPIC by native/__init__.py; a plain C interface.
#include <cstdint>
#include <vector>

extern "C" int32_t slt_greedy_coloring(
    const int64_t* indptr, const int32_t* indices,
    const int64_t* t_indptr, const int32_t* t_indices,
    int64_t n, int32_t* colors) {
    for (int64_t i = 0; i < n; ++i) colors[i] = -1;
    // mark[c] == i: color c is taken by a neighbour of row i
    std::vector<int32_t> mark(n, -1);
    int32_t max_color = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            int32_t j = indices[k];
            if (j != i && colors[j] >= 0) mark[colors[j]] = (int32_t)i;
        }
        for (int64_t k = t_indptr[i]; k < t_indptr[i + 1]; ++k) {
            int32_t j = t_indices[k];
            if (j != i && colors[j] >= 0) mark[colors[j]] = (int32_t)i;
        }
        int32_t c = 0;
        while (c < (int32_t)n && mark[c] == (int32_t)i) ++c;
        colors[i] = c;
        if (c + 1 > max_color) max_color = c + 1;
    }
    return max_color;
}
