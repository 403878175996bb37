// Phase marks of K1 (bcd_fused.cu) and K2 (csr_stats.cu), read by
// scripts/phase_trace.py.  Empty here: the kernels built by the package
// carry no instrumentation.  The script builds copies of the sources that
// define the marks first, recording per unit (a CTA, or a problem in K1)
// the SM clock and the global timer:
//
//   PHASE_START(who, unit)        the unit's start
//   PHASE_MARK(who, unit, col)    column col := SM clock since the start
//                                 (the end of a straight-line phase)
//   PHASE_SPAN(who, unit, col)    column col += SM clock since the unit's
//                                 previous START or SPAN (a phase that
//                                 recurs in a loop)
//   PHASE_COUNT(who, unit, col, n) column col += n
//
// Each mark acts only where `who` holds; one thread of a unit marks it.
#pragma once

#ifndef PHASE_START
#define PHASE_START(who, unit) ((void)0)
#define PHASE_MARK(who, unit, col) ((void)0)
#define PHASE_SPAN(who, unit, col) ((void)0)
#define PHASE_COUNT(who, unit, col, n) ((void)0)
#endif
