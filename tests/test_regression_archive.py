"""Tier-3 regression test: outputs vs the committed archive.

Equivalent of the reference's archived-NetCDF comparison
(reference: environment_changes_eval.ipynb cells 9-14): the full pipeline's
outputs on a fixed grid must match the committed archive variable-by-
variable, with NaN-pattern equality — any drift (dependency bump, refactor,
constant change) fails loudly with the offending variable named.
"""

import json
import os

import numpy as np
import pytest

from make_regression_archive import (ARCHIVE, DRIFT, assert_matches_archive,
                                    compute, load_archive, make_inputs)


@pytest.mark.skipif(not os.path.exists(ARCHIVE),
                    reason='archive not generated')
def test_conv_properties_regression():
    inputs, expect = load_archive()

    fresh_inputs = make_inputs()
    for k, v in fresh_inputs.items():
        np.testing.assert_array_equal(
            v, inputs[k], err_msg=f'input generator drifted: {k}')

    assert_matches_archive(compute(inputs), expect)


@pytest.mark.skipif(not os.path.exists(ARCHIVE),
                    reason='archive not generated')
def test_committed_drift_record():
    """Every regeneration of the archive ships with a committed drift
    record (the reference's analogue is its committed historic archives,
    reference: .MISSING_LARGE_BLOBS:1-2, eval nb cells 9-14):
    tests/data/regression_drift.json must exist with the compare_archives
    report shape, every current variable covered, and no leftover
    cross-version key asymmetry."""
    assert os.path.exists(DRIFT), (
        'tests/data/regression_drift.json missing — run '
        'python tests/make_regression_archive.py and commit the record')
    with open(DRIFT) as f:
        report = json.load(f)
    assert set(report) == {'equal', 'n_differs', 'only_in_current',
                           'only_in_historic', 'variables'}
    assert report['n_differs'] == sum(
        not r['within_tolerance'] for r in report['variables'])
    names = {r['name'] for r in report['variables']}
    with np.load(ARCHIVE) as f:
        archived = {k[4:] for k in f.files if k.startswith('out_')}
    # The drift record covers the archive's variable set (variables only in
    # one side are listed in the asymmetry keys instead).
    assert archived == names | set(report['only_in_historic'])
    for r in report['variables']:
        assert set(r) == {'max_abs_diff', 'max_rel_diff_pct', 'name',
                          'nan_pattern_equal', 'within_tolerance'}


@pytest.mark.skipif(not os.path.exists(ARCHIVE),
                    reason='archive not generated')
def test_compare_archives_drift_table(capsys):
    """The archive-vs-archive drift tool (the reference's current-vs-
    historic evaluation, environment_changes_eval.ipynb cells 9-14):
    self-comparison is clean; a perturbed copy is flagged per variable,
    including NaN-pattern changes and asymmetric key sets."""
    from xarray_parcel_tpu.utils import compare_archives

    # Path in, self-comparison: everything equal.
    report = compare_archives(ARCHIVE, ARCHIVE, print_report=False)
    assert report['equal'] and report['n_differs'] == 0
    assert not report['only_in_current'] and not report['only_in_historic']
    assert len(report['variables']) > 20

    # Perturb one value, flip one NaN, drop one variable, add one.
    with np.load(ARCHIVE) as f:
        cur = {k[4:]: np.array(f[k]) for k in f.files if k.startswith('out_')}
    cur['mu_cape'] = cur['mu_cape'] + 5.0
    flh = cur['freezing_level']
    flh.flat[np.flatnonzero(~np.isnan(flh))[0]] = np.nan
    dropped = cur.pop('ship')
    cur['new_diag'] = dropped
    report = compare_archives(cur, ARCHIVE)
    out = capsys.readouterr().out
    assert not report['equal']
    by_name = {r['name']: r for r in report['variables']}
    assert not by_name['mu_cape']['within_tolerance']
    assert by_name['mu_cape']['max_abs_diff'] == pytest.approx(5.0)
    assert not by_name['freezing_level']['nan_pattern_equal']
    assert report['only_in_current'] == ['new_diag']
    assert report['only_in_historic'] == ['ship']
    assert 'mu_cape' in out and 'DIFFERS' in out and 'only in historic' in out
