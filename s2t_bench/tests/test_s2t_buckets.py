"""The bucket formula against edges worked by hand."""

from s2t_bench.workload import BucketSpec, bucket_specs


def test_hand_worked_edges():
    durations = [1.0, 1.5, 2.0, 3.0, 4.0]
    tokens = [4, 6, 9, 13, 20]
    specs = bucket_specs(durations, tokens, num_buckets=2,
                         volume_threshold=10.0, min_batch_size=3,
                         max_batch_size=512, sample_rate=16000,
                         pcm_multiple=16000, label_multiple=8,
                         speed_perturb_slack=1.12)
    # edges linspace(1, 4, 3)[1:] = 2.5, 4.0
    # bucket 1: 10/2.5 = 4 rows; ceil(2.5·16000·1.12) = 44800 → 48000;
    #   p99.5 of (4, 6, 9) = 8.97 → int 8 → 8
    # bucket 2: 10/4 = 2 → min 3 rows; ceil(4·16000·1.12) = 71680 → 80000;
    #   p99.5 of (13, 20) = 19.965 → 19 → 24
    assert specs == [BucketSpec(2.5, 4, 48000, 8),
                     BucketSpec(4.0, 3, 80000, 24)]


def test_cap_and_empty_bucket():
    specs = bucket_specs([1.0, 1.1, 9.0], [3, 3, 40], num_buckets=4,
                         volume_threshold=5000.0, min_batch_size=16,
                         max_batch_size=512, sample_rate=16000,
                         pcm_multiple=16000, label_multiple=8,
                         speed_perturb_slack=1.0)
    # edges 3, 5, 7, 9: the middle two are empty and left out
    assert [s.hi_duration for s in specs] == [3.0, 9.0]
    assert specs[0].batch_size == 512             # 5000/3 capped
    assert specs[1].batch_size == 512             # int(5000/9) = 555, capped
